"""SAM 2.1 with a Hiera image encoder (``sam2.1_hiera_*.yaml``): everything
of the benchmark that reads the SAM 2 side of a configuration (its
``image_size``, ``trunk``, ``neck``, ``prompt_encoder`` and
``mask_decoder`` groups, named as the published yaml names them).

The hooks are those of ``families/sam_vit.py`` (``sam_spec``, ``build``,
``ENCODER_CLASS``, ``encoder_units``, ``prompt_flops``, ``geometry``,
``embed``, ``crops``). ``embed`` returns the embedding with the decoder's
two high-resolution levels; ``crops`` computes every prompt's whole low-res
masks, so the single mask is the image predictor's stability choice over
token 0's whole mask. The plain SAM 2 is ``cytobench/reference/sam2.py``.

The judge compares each mask with the reference's mask of the token the
program took: the program hands on each slot's token (``mask_token``),
``build`` notes it under the batch's boxes, and ``crops``, given those
boxes, gives that token's mask, in fp32 and in the bf16 yardstick alike.
So the mask numbers judge the encoder, the neck, the decoder and the head
token for token. The choice itself is not held to the fp32 one: on these
weights rounding moves token 0's stability across the threshold for up to
45% of a batch's prompts, in the bf16 yardstick as in the program
(``PERF.md`` §2); each judged batch prints how often the choices differ.
"""

from __future__ import annotations

import collections
import math
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cytobench.flops import BF16
from cytobench.reference import preprocess, sam2
from cytobench.reference.pipeline import _block, offsets
from cytobench.reference.sam import crop_sample
from cytobench.weights import _gain, _normal

ENCODER_CLASS = "HieraImageEncoder"
# the program's tokens by the bytes of its batch's boxes, the newest kept
_CHOICES: "collections.OrderedDict[bytes, Dict]" = collections.OrderedDict()
_KEEP = 64


def _mlp_width(t: Dict, dim: int) -> int:
    return int(dim * t["mlp_ratio"])


def sam_spec(cfg: Dict) -> Dict:
    t, nk = cfg["trunk"], cfg["neck"]
    p, d = cfg["prompt_encoder"], cfg["mask_decoder"]
    c0, k = t["embed_dim"], t["patch_kernel_size"]
    oc = nk["d_model"]

    def dense(i, o):
        return {"w": _normal((i, o), 1.0 / math.sqrt(i)), "b": _normal((o,), 0.02)}

    def ln(n, outliers=False):
        return {"scale": _gain(n, outliers), "bias": _normal((n,), 0.02)}

    def block(dim, dim_out):
        hid = _mlp_width(t, dim_out)
        out = {"ln1": ln(dim, True), "qkv": dense(dim, 3 * dim_out),
               "proj": dense(dim_out, dim_out), "ln2": ln(dim_out, True),
               "mlp1": dense(dim_out, hid), "mlp2": dense(hid, dim_out)}
        if dim != dim_out:
            out["shortcut"] = dense(dim, dim_out)
        return out

    di = d["transformer_dim"]
    down = di // d["attention_downsample_rate"]

    def attn(inner):
        return {"q": dense(di, inner), "k": dense(di, inner), "v": dense(di, inner),
                "out": dense(inner, di)}

    def ff(i, h, o, depth):
        return {"in": dense(i, h), "hidden": [dense(h, h) for _ in range(depth - 2)],
                "out": dense(h, o)}

    m = d["num_multimask_outputs"] + 1
    bkg = t["window_pos_embed_bkg_spatial_size"]
    win = t["window_spec"][0]
    return {
        "vision": {
            "patch_embed": {"w": _normal((k, k, 3, c0), 1.0 / math.sqrt(k * k * 3)),
                            "b": _normal((c0,), 0.02)},
            "pos_embed": _normal((bkg[0], bkg[1], c0), 0.1),
            "pos_embed_window": _normal((win, win, c0), 0.1),
            "blocks": [block(dim, dim_out) for dim, dim_out, _, _, _ in sam2.blocks(t)],
            "neck": {"lateral": [dense(ci, oc) for ci in reversed(nk["backbone_channel_list"])],
                     "conv_s0": dense(oc, oc // 8), "conv_s1": dense(oc, oc // 4)},
            "no_mem_embed": _normal((oc,), 0.1),
        },
        "prompt": {"point_embed": _normal((4, p["embed_dim"]), 1.0),
                   "not_a_point": _normal((p["embed_dim"],), 1.0),
                   "no_mask": _normal((p["embed_dim"],), 0.1), "mask_embed": None},
        "decoder": {
            "obj_score_token": _normal((1, di), 1.0),
            "iou_token": _normal((1, di), 1.0), "mask_tokens": _normal((m, di), 1.0),
            "layers": [{"self_attn": attn(di), "ln1": ln(di), "t2i": attn(down), "ln2": ln(di),
                        "mlp1": dense(di, d["mlp_dim"]), "mlp2": dense(d["mlp_dim"], di),
                        "ln3": ln(di), "i2t": attn(down), "ln4": ln(di)}
                       for _ in range(d["depth"])],
            "final_t2i": attn(down), "ln_final": ln(di),
            "up1_w": _normal((di, di // 4, 2, 2), 1.0 / math.sqrt(di)),
            "up1_b": _normal((di // 4,), 0.02), "up_ln": ln(di // 4),
            "up2_w": _normal((di // 4, di // 8, 2, 2), 1.0 / math.sqrt(di // 4)),
            "up2_b": _normal((di // 8,), 0.02),
            "hyper_mlps": [ff(di, di, di // 8, 3) for _ in range(m)],
            "iou_head": ff(di, d["iou_head_hidden_dim"], m, d["iou_head_depth"]),
        },
        "shared_pe": _normal((2, p["embed_dim"] // 2), 1.0),
    }


def port_config(cfg: Dict):
    """The port's ``Sam2Config`` of the configuration."""
    from yolo_sam_inference_tpu_torch.models.sam import Sam2Config

    t, nk, p, d = (cfg[g] for g in ("trunk", "neck", "prompt_encoder", "mask_decoder"))
    return Sam2Config(
        image_size=cfg["image_size"], embed_dim=t["embed_dim"], num_heads=t["num_heads"],
        stages=tuple(t["stages"]), window_spec=tuple(t["window_spec"]),
        global_att_blocks=tuple(t["global_att_blocks"]),
        pos_embed_bkg=t["window_pos_embed_bkg_spatial_size"][0],
        patch_kernel=t["patch_kernel_size"], patch_stride=t["patch_stride"],
        mlp_ratio=t["mlp_ratio"], fpn_top_down_levels=tuple(nk["fpn_top_down_levels"]),
        scalp=nk["scalp"], output_channels=nk["d_model"], prompt_hidden=p["embed_dim"],
        num_pos_feats=p["embed_dim"] // 2, decoder_layers=d["depth"],
        decoder_heads=d["num_heads"], decoder_mlp_dim=d["mlp_dim"],
        iou_head_hidden=d["iou_head_hidden_dim"], iou_head_depth=d["iou_head_depth"],
        num_multimask_outputs=d["num_multimask_outputs"], layer_norm_eps=t["layer_norm_eps"],
        decoder_layer_norm_eps=d["layer_norm_eps"],
        stability_delta=d["dynamic_multimask_stability_delta"],
        stability_thresh=d["dynamic_multimask_stability_thresh"])


def build(cfg: Dict, traffic: Dict, seed: int, device, quant: str = "none"):
    """The port's pipeline with SAM 2 at the configuration's sizes, at its
    canvas (the port has no int8 SAM 2: ``quant="int8"`` is refused). Each
    fetch notes the tokens the program took, for :func:`crops`."""
    from cytobench.run import port_pipeline

    pipe = port_pipeline(cfg, traffic, seed, device, quant, port_config(cfg), cfg["image_size"])
    fetch = pipe._fetch_outputs

    def fetch_and_note(h):
        out = fetch(h)
        note(out["boxes"], out["mask_token"])
        return out

    pipe._fetch_outputs = fetch_and_note
    return pipe


def _key(boxes) -> bytes:
    if isinstance(boxes, torch.Tensor):
        boxes = boxes.detach().float().cpu().numpy()
    return np.ascontiguousarray(boxes, dtype=np.float32).tobytes()


def note(boxes, tokens) -> None:
    """Note the tokens (B, K) a program chose for a batch's boxes (B, K, 4).
    A batch seen again with other tokens (a program that is not
    deterministic) marks those slots ``varied``: no token is taken there."""
    key = _key(boxes)
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.cpu()
    tokens = np.asarray(tokens, dtype=np.int64)
    old = _CHOICES.pop(key, None)
    varied = np.zeros_like(tokens, bool) if old is None else old["varied"] | (old["program"] != tokens)
    _CHOICES[key] = {"program": tokens, "varied": varied}
    while len(_CHOICES) > _KEEP:
        _CHOICES.popitem(last=False)


def trunk_grid(cfg: Dict) -> int:
    return cfg["image_size"] // cfg["trunk"]["patch_stride"]


def grid_side(cfg: Dict) -> int:
    """The side of the image embedding: the last level the scalp keeps."""
    t = cfg["trunk"]
    return trunk_grid(cfg) >> (len(t["stages"]) - 1 - cfg["neck"]["scalp"])


def encoder_units(cfg: Dict) -> List[Tuple[float, float, float]]:
    """The encoder as units of (operations an image, activation bytes an
    image, weight bytes): the patch embedding, each block at its own tokens,
    width, heads, window and pooling (qkv, the shortcut's projection where
    the width changes, attention at 4 q k dim_out a window, the projection,
    the MLP), and the neck with the decoder's high-resolution convs."""
    t, nk = cfg["trunk"], cfg["neck"]
    k, c0 = t["patch_kernel_size"], t["embed_dim"]
    s = trunk_grid(cfg)
    units = [(2.0 * s * s * k * k * 3 * c0, BF16 * (cfg["image_size"] ** 2 * 3 + s * s * c0),
              BF16 * (k * k * 3 * c0 + c0))]
    for dim, dim_out, _, window, pool in sam2.blocks(t):
        s_out = s // 2 if pool else s
        t_in, t_out = s * s, s_out * s_out
        w = window or s
        windows = (s // w) ** 2
        wq = w // 2 if pool else w
        hid = _mlp_width(t, dim_out)
        ops = 2.0 * t_in * dim * 3 * dim_out + 4.0 * windows * (wq * wq) * (w * w) * dim_out \
            + 2.0 * t_out * dim_out * dim_out + 4.0 * t_out * dim_out * hid
        wts = (dim * 3 * dim_out + dim_out * dim_out + 2 * dim_out * hid + 4 * dim + 7 * dim_out
               + hid)
        if dim != dim_out:
            ops += 2.0 * t_in * dim * dim_out
            wts += dim * dim_out + dim_out
        units.append((ops, BF16 * (t_in * dim + t_out * dim_out), BF16 * wts))
        s = s_out
    oc = nk["d_model"]
    side, ops, act, wts = trunk_grid(cfg), 0.0, 0, 0
    for ci in reversed(nk["backbone_channel_list"]):
        ops += 2.0 * side * side * ci * oc
        act += side * side * (ci + oc)
        wts += ci * oc + oc
        side //= 2
    g0 = trunk_grid(cfg)
    for c_out, g in ((oc // 8, g0), (oc // 4, g0 // 2)):
        ops += 2.0 * g * g * oc * c_out
        act += g * g * c_out
        wts += oc * c_out + c_out
    units.append((ops, BF16 * act, BF16 * wts))
    return units


def window_side(cfg: Dict, traffic: Dict) -> int:
    """The side of the token window around each cell whose chosen mask is
    sampled: the crop in tokens, plus 3, at most the grid."""
    gs = grid_side(cfg)
    crop = min(traffic["metric_crop"], traffic["frame_size"])
    per_token = cfg["image_size"] / traffic["frame_size"] * gs / cfg["image_size"]
    return min(gs, int(math.ceil(crop * per_token)) + 3)


def prompt_flops(cfg: Dict, traffic: Dict, g: Optional[int] = None) -> float:
    """One box prompt: the two-way decoder at 9 tokens (object score, IoU, 4
    masks, 2 corners and a padding point) over the image's tokens, the 4
    hypernetwork MLPs and the IoU head, the whole upscaling (both transposed
    convs over the whole grid), token 0's logits over the whole low-res grid
    and the chosen token's on a g x g window. The object-score MLP is not
    run (nothing reads it in the image predictor) and is not counted."""
    d = cfg["mask_decoder"]
    gs = grid_side(cfg)
    t = gs * gs
    c = d["transformer_dim"]
    inner = c // d["attention_downsample_rate"]
    masks = d["num_multimask_outputs"] + 1
    tq = 2 + masks + 3

    def attn(nq, nk, dim):
        return 2.0 * (nq * c * dim + 2 * nk * c * dim + nq * dim * c) + 4.0 * nq * nk * dim

    per_layer = attn(tq, tq, c) + attn(tq, t, inner) + 4.0 * tq * c * d["mlp_dim"] \
        + attn(t, tq, inner)
    ih = d["iou_head_hidden_dim"]
    heads = masks * 2.0 * (2 * c * c + c * c // 8) \
        + 2.0 * (c * ih + (d["iou_head_depth"] - 2) * ih * ih + ih * masks)
    g = window_side(cfg, traffic) if g is None else g
    up = 2.0 * t * 4 * c * (c // 4) + 2.0 * (2 * gs) ** 2 * 4 * (c // 4) * (c // 8) \
        + 2.0 * (4 * gs) ** 2 * (c // 8) + 2.0 * (4 * g) ** 2 * (c // 8)
    return d["depth"] * per_layer + attn(tq, t, inner) + heads + up


def geometry(cfg: Dict, traffic: Dict) -> Dict:
    """SAM 2's canvas and grid, the crop side and the scale from frame pixels
    to the low-resolution logits (square frames: SAM 2 resizes to the canvas)."""
    side = traffic["frame_size"]
    canvas = cfg["image_size"]
    gs = grid_side(cfg)
    sam_scale = canvas / side
    return {"canvas": canvas, "gs": gs, "sam_scale": sam_scale,
            "crop": min(traffic["metric_crop"], side), "to_low": sam_scale * 4 * gs / canvas}


def embed(stree: Dict, frames: torch.Tensor, cfg: Dict, traffic: Dict,
          quant: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frames' (embedding (B, gs, gs, C), feat_s1, feat_s0), fp32. SAM
    2's transforms resize to the canvas and normalise with ImageNet's mean
    and std, as ``preprocess.sam_pixels`` does on square frames."""
    g = geometry(cfg, traffic)
    s = trunk_grid(cfg)
    step = _block(s * s * _mlp_width(cfg["trunk"], cfg["trunk"]["embed_dim"]) * 4 * 4)
    out = []
    for i in range(0, frames.shape[0], step):
        pix = preprocess.sam_pixels(frames[i:i + step], g["canvas"])
        out.append([f.float() for f in sam2.encoder(stree["vision"], cfg, pix, quant)])
    return tuple(torch.cat(parts) for parts in zip(*out))


def crops(stree: Dict, emb, boxes: torch.Tensor, valid: torch.Tensor, frame_hw, cfg: Dict,
          traffic: Dict, quant: Optional[str] = None) -> Dict:
    """For every box (B, K, 4): its crop origin (B, K, 2), the fp32 logits of
    its crop (B, K, crop, crop) sampled from its single low-res mask, and the
    mask's token (B, K; -1 where invalid); invalid slots' logits are -inf
    (no mask). The decoder and the upscaling run in the type of the tree.
    The single mask is of the token a program noted for these boxes
    (:func:`note`), else of this reference's own choice; with ``quant``
    (the reference in the program's place) its own choice is noted."""
    g = geometry(cfg, traffic)
    d = cfg["mask_decoder"]
    e, s1, s0 = emb
    b, k = boxes.shape[:2]
    h, w = frame_hw
    off = offsets(boxes, g["crop"], h, w)
    logits = torch.full((b, k, g["crop"], g["crop"]), -math.inf, device=e.device)
    own = torch.full((b, k), -1, dtype=torch.long, device=e.device)
    token = own.clone()
    idx = valid.nonzero()
    dt = stree["decoder"]["iou_token"].dtype
    delta, thresh = d["dynamic_multimask_stability_delta"], d["dynamic_multimask_stability_thresh"]
    key = _key(boxes)
    if quant is not None:  # the reference in the program's place: its own choice is the program's
        _CHOICES.pop(key, None)
    entry = _CHOICES.get(key)
    take = None
    if entry is not None:
        take = torch.as_tensor(np.where(entry["varied"], -1, entry["program"]), device=e.device)
    step = _block(sam2.step_bytes(g["gs"], d["transformer_dim"]))
    for i in range(0, idx.shape[0], step):
        bi, ki = idx[i:i + step].unbind(1)
        sparse = sam2.box_tokens(stree, boxes[bi, ki] * g["sam_scale"], g["canvas"])
        hyper, iou, keys = sam2.decode(stree, e[bi].to(dt), sparse, d["num_heads"],
                                       d["layer_norm_eps"], quant)
        low = sam2.mask_logits(stree, keys, s1[bi].to(dt), s0[bi].to(dt), hyper)
        _, own[bi, ki] = sam2.single_mask(low, iou, delta, thresh)
        t = own[bi, ki] if take is None else take[bi, ki]
        token[bi, ki] = t = torch.where(t < 0, own[bi, ki], t)
        low = low[torch.arange(low.shape[0], device=low.device), t]
        logits[bi, ki] = crop_sample(low, off[bi, ki], g["crop"], g["to_low"])
    if quant is not None:
        note(boxes, own)
    elif entry is not None:
        _report(entry, own, valid, dt)
        if dt == torch.float32:
            entry["fp32"] = own
    return {"offsets": off, "logits": logits, "token": token}


def _report(entry: Dict, own, valid, dt) -> None:
    """One line on a judged batch's choices: where this reference's own token
    differs from the program's (and, for the yardstick, from the fp32
    reference's own)."""
    prog = torch.as_tensor(entry["program"], device=own.device)
    v = valid & (prog >= 0)
    differ = v & (own != prog)
    line = (f"judged sam2 choices, {str(dt).replace('torch.', '')} reference: {int(v.sum())} "
            f"prompts; its own token differs from the program's on {int(differ.sum())} (the "
            f"stability side on {int((differ & ((own == 0) != (prog == 0))).sum())}); "
            f"{int(np.sum(entry['varied']))} slots varied between fetches")
    if dt != torch.float32 and "fp32" in entry:
        line += (f"; its own token differs from the fp32 reference's on "
                 f"{int((v & (own != entry['fp32'])).sum())}")
    print(line, file=sys.stderr)
