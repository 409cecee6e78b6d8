"""The SAM family with a ViT image encoder (ViT-B / L / H): everything of
the benchmark that reads the SAM side of a configuration (its
``vision_config``, ``prompt_encoder_config`` and ``mask_decoder_config``).

A family is a module of plain functions, found by the configuration's key
``family`` (``cytobench/manifest.py``):

* ``sam_spec(cfg)``: the SAM weight tree to draw (``cytobench/weights.py``);
* ``build(cfg, traffic, seed, device, quant)``: the port's pipeline;
* ``ENCODER_CLASS``: the class name of the port's image encoder module,
  whose calls the traced window marks (``cytobench/trace.py``);
* ``encoder_units(cfg)``, ``prompt_flops(cfg, traffic, g)``: the encoder's
  and a prompt's operations and bytes (``cytobench/flops.py``);
* ``embed(stree, frames, cfg, traffic, quant)`` and ``crops(stree, emb,
  boxes, valid, frame_hw, cfg, traffic, quant)``: the reference's image
  embedding and, from it, each box's crop origin and fp32 mask logits
  (``cytobench/reference/pipeline.py``). The judge hands ``embed``'s result
  to ``crops`` without reading it.

The plain ViT-SAM is ``cytobench/reference/sam.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from cytobench.flops import BF16
from cytobench.reference import preprocess, sam
from cytobench.reference.pipeline import _block, offsets
from cytobench.weights import _gain, _normal

ENCODER_CLASS = "SamImageEncoder"


def sam_spec(cfg: Dict) -> Dict:
    v, p, d = cfg["vision_config"], cfg["prompt_encoder_config"], cfg["mask_decoder_config"]
    c, ps = v["hidden_size"], v["patch_size"]
    gs = v["image_size"] // ps
    hd = c // v["num_attention_heads"]
    oc = v["output_channels"]

    def dense(i, o):
        return {"w": _normal((i, o), 1.0 / math.sqrt(i)), "b": _normal((o,), 0.02)}

    def ln(n, outliers=False):
        return {"scale": _gain(n, outliers), "bias": _normal((n,), 0.02)}

    def layer(i):
        ws = gs if i in v["global_attn_indexes"] else v["window_size"]
        return {"ln1": ln(c, True),
                "attn": {"qkv": dense(c, 3 * c), "proj": dense(c, c),
                         "rel_pos_h": _normal((2 * ws - 1, hd), 0.1),
                         "rel_pos_w": _normal((2 * ws - 1, hd), 0.1)},
                "ln2": ln(c, True), "mlp1": dense(c, v["mlp_dim"]), "mlp2": dense(v["mlp_dim"], c)}

    di = d["hidden_size"]
    down = di // d["attention_downsample_rate"]

    def attn(inner):
        return {"q": dense(di, inner), "k": dense(di, inner), "v": dense(di, inner),
                "out": dense(inner, di)}

    def ff(i, h, o, depth):
        return {"in": dense(i, h), "hidden": [dense(h, h) for _ in range(depth - 2)],
                "out": dense(h, o)}

    m = d["num_multimask_outputs"] + 1
    return {
        "vision": {
            "patch_embed": {"w": _normal((ps, ps, 3, c), 1.0 / math.sqrt(ps * ps * 3)),
                            "b": _normal((c,), 0.02)},
            "pos_embed": _normal((1, gs, gs, c), 0.1),
            "layers": [layer(i) for i in range(v["num_hidden_layers"])],
            "neck": {"conv1_w": _normal((c, oc), 1.0 / math.sqrt(c)), "ln1": ln(oc),
                     "conv2_w": _normal((3, 3, oc, oc), 1.0 / math.sqrt(9 * oc)), "ln2": ln(oc)},
        },
        "prompt": {"point_embed": _normal((4, p["hidden_size"]), 1.0),
                   "not_a_point": _normal((p["hidden_size"],), 1.0),
                   "no_mask": _normal((p["hidden_size"],), 0.1), "mask_embed": None},
        "decoder": {
            "iou_token": _normal((1, di), 1.0), "mask_tokens": _normal((m, di), 1.0),
            "layers": [{"self_attn": attn(di), "ln1": ln(di), "t2i": attn(down), "ln2": ln(di),
                        "mlp1": dense(di, d["mlp_dim"]), "mlp2": dense(d["mlp_dim"], di),
                        "ln3": ln(di), "i2t": attn(down), "ln4": ln(di)}
                       for _ in range(d["num_hidden_layers"])],
            "final_t2i": attn(down), "ln_final": ln(di),
            "up1_w": _normal((di, di // 4, 2, 2), 1.0 / math.sqrt(di)),
            "up1_b": _normal((di // 4,), 0.02), "up_ln": ln(di // 4),
            "up2_w": _normal((di // 4, di // 8, 2, 2), 1.0 / math.sqrt(di // 4)),
            "up2_b": _normal((di // 8,), 0.02),
            "hyper_mlps": [ff(di, di, di // 8, 3) for _ in range(m)],
            "iou_head": ff(di, d["iou_head_hidden_dim"], m, d["iou_head_depth"]),
        },
        "shared_pe": _normal((2, p["hidden_size"] // 2), 1.0),
    }


def build(cfg: Dict, traffic: Dict, seed: int, device, quant: str = "none"):
    """The port's pipeline with SAM's ViT at the configuration's sizes,
    encoding at its canvas."""
    from yolo_sam_inference_tpu_torch.models.sam import SamTPUConfig

    from cytobench.run import port_pipeline

    v, p, d = (cfg[k] for k in ("vision_config", "prompt_encoder_config", "mask_decoder_config"))
    scfg = SamTPUConfig(
        image_size=v["image_size"], patch_size=v["patch_size"], vision_hidden=v["hidden_size"],
        vision_layers=v["num_hidden_layers"], vision_heads=v["num_attention_heads"],
        vision_mlp_dim=v["mlp_dim"], window_size=v["window_size"],
        global_attn_indexes=tuple(v["global_attn_indexes"]), output_channels=v["output_channels"],
        prompt_hidden=p["hidden_size"], num_pos_feats=p["hidden_size"] // 2,
        decoder_layers=d["num_hidden_layers"], decoder_heads=d["num_attention_heads"],
        decoder_mlp_dim=d["mlp_dim"], iou_head_hidden=d["iou_head_hidden_dim"],
        iou_head_depth=d["iou_head_depth"], num_multimask_outputs=d["num_multimask_outputs"],
        layer_norm_eps=v["layer_norm_eps"], decoder_layer_norm_eps=d["layer_norm_eps"])
    return port_pipeline(cfg, traffic, seed, device, quant, scfg, v["image_size"])


def encoder_units(cfg: Dict) -> List[Tuple[float, float, float]]:
    """The encoder as units of (operations an image, activation bytes an
    image, weight bytes): the patch embedding, each layer, the neck."""
    v = cfg["vision_config"]
    c, heads, m, ps = v["hidden_size"], v["num_attention_heads"], v["mlp_dim"], v["patch_size"]
    gs = v["image_size"] // ps
    t = gs * gs
    hd = c // heads
    oc = v["output_channels"]
    units = [(2.0 * t * ps * ps * 3 * c, BF16 * (t * ps * ps * 3 + t * c),
              BF16 * (ps * ps * 3 * c + c))]
    for i in range(v["num_hidden_layers"]):
        w = gs if i in v["global_attn_indexes"] else v["window_size"]
        windows = t // (w * w)
        linear = 2.0 * t * (3 * c * c + c * c + 2 * c * m)
        attn = windows * heads * (4.0 * (w * w) ** 2 * hd + 4.0 * (w * w) * w * hd)
        weights = BF16 * (4 * c * c + 2 * c * m + 4 * c + 3 * c + m + 2 * (2 * w - 1) * hd)
        units.append((linear + attn, BF16 * 2 * t * c, weights))
    units.append((2.0 * t * (c * oc + 9 * oc * oc), BF16 * (t * c + t * oc),
                  BF16 * (c * oc + 9 * oc * oc + 4 * oc)))
    return units


def window_side(cfg: Dict, traffic: Dict) -> int:
    """The side of the token window around each cell that the mask head
    upscales: the crop in tokens, plus 3, at most the grid."""
    v = cfg["vision_config"]
    gs = v["image_size"] // v["patch_size"]
    crop = min(traffic["metric_crop"], traffic["frame_size"])
    per_token = v["image_size"] / traffic["frame_size"] / v["patch_size"]
    return min(gs, int(math.ceil(crop * per_token)) + 3)


def prompt_flops(cfg: Dict, traffic: Dict, g: Optional[int] = None) -> float:
    """One box prompt through the two-way decoder over the image's tokens,
    the hypernetwork and IoU heads, and the mask head on a g x g window."""
    v, d = cfg["vision_config"], cfg["mask_decoder_config"]
    gs = v["image_size"] // v["patch_size"]
    t = gs * gs
    c = d["hidden_size"]
    inner = c // d["attention_downsample_rate"]
    masks = d["num_multimask_outputs"] + 1
    tq = 1 + masks + 2

    def attn(nq, nk, dim):
        return 2.0 * (nq * c * dim + 2 * nk * c * dim + nq * dim * c) + 4.0 * nq * nk * dim

    per_layer = attn(tq, tq, c) + attn(tq, t, inner) + 4.0 * tq * c * d["mlp_dim"] \
        + attn(t, tq, inner)
    ih = d["iou_head_hidden_dim"]
    heads = masks * 2.0 * (2 * c * c + c * c // 8) \
        + 2.0 * (c * ih + (d["iou_head_depth"] - 2) * ih * ih + ih * masks)
    g = window_side(cfg, traffic) if g is None else g
    up = 2.0 * g * g * 4 * c * (c // 4) + 2.0 * (2 * g) ** 2 * 4 * (c // 4) * (c // 8) \
        + 2.0 * (4 * g) ** 2 * (c // 8)
    return d["num_hidden_layers"] * per_layer + attn(tq, t, inner) + heads + up


def geometry(cfg: Dict, traffic: Dict) -> Dict:
    """The shapes the pipeline derives from the frame: SAM's canvas and
    grid, the crop side and the scale from frame pixels to the
    low-resolution logits."""
    v = cfg["vision_config"]
    side = traffic["frame_size"]
    canvas = v["image_size"]
    gs = canvas // v["patch_size"]
    sam_scale = canvas / side
    return {"canvas": canvas, "gs": gs, "sam_scale": sam_scale, "crop": min(traffic["metric_crop"], side), "to_low": sam_scale * 4 * gs / canvas}


def embed(stree: Dict, frames: torch.Tensor, cfg: Dict, traffic: Dict,
          quant: Optional[str] = None) -> torch.Tensor:
    """SAM's image embeddings (B, gs, gs, C) of the frames."""
    g = geometry(cfg, traffic)
    v = dict(cfg["vision_config"], image_size=g["canvas"])
    step = _block(g["gs"] ** 2 * v["mlp_dim"] * 4 * 4)
    out = []
    for s in range(0, frames.shape[0], step):
        pix = preprocess.sam_pixels(frames[s:s + step], g["canvas"])
        out.append(sam.encoder(stree["vision"], v, pix, quant).float())
    return torch.cat(out)


def crops(stree: Dict, emb: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
          frame_hw, cfg: Dict, traffic: Dict, quant: Optional[str] = None) -> Dict:
    """For every box (B, K, 4): its crop origin (B, K, 2) and the fp32 mask
    logits of its crop (B, K, crop, crop); invalid slots' logits are -inf
    (no mask). The decoder and the upscaling run in the type of the tree."""
    g = geometry(cfg, traffic)
    d = cfg["mask_decoder_config"]
    b, k = boxes.shape[:2]
    h, w = frame_hw
    off = offsets(boxes, g["crop"], h, w)
    logits = torch.full((b, k, g["crop"], g["crop"]), -math.inf, device=emb.device)
    idx = valid.nonzero()
    step = _block(g["gs"] ** 2 * max(d["hidden_size"], 16 * 64) * 4 * 4)
    for s in range(0, idx.shape[0], step):
        bi, ki = idx[s:s + step].unbind(1)
        sparse = sam.box_tokens(stree, boxes[bi, ki] * g["sam_scale"], g["canvas"])
        dt = stree["decoder"]["iou_token"].dtype
        hyper, keys = sam.decode(stree, emb[bi].to(dt), sparse, d["num_attention_heads"], quant)
        low = sam.mask_logits(stree, keys, hyper)
        logits[bi, ki] = sam.crop_sample(low, off[bi, ki], g["crop"], g["to_low"])
    return {"offsets": off, "logits": logits}
