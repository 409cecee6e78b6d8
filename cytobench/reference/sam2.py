"""SAM 2.1's image path in plain fp32, as the benchmarked pipeline uses it:
the Hiera trunk (windowed and global attention, the queries and the shortcut
max-pooled at each stage's first block), the FPN neck and the decoder's
high-resolution projections, the box prompt (two corner points labelled 2
and 3 and a padding point), SAM's two-way transformer with SAM 2's
object-score token first, the mask head with both high-resolution levels
added, and the image predictor's single mask: token 0's whole low-res mask
unless its stability is below the threshold, then the best of tokens 1.. by
predicted IoU. After ``sam2/modeling/backbones/hieradet.py``,
``image_encoder.py``, ``sam/mask_decoder.py``, ``sam2_base.py::
forward_image`` and ``sam2_image_predictor.py``.

Weights are the benchmark's tree (``cytobench/families/sam2_hiera.py``):
linear weights ``(in, out)``, the patch embedding HWIO, the position tables
``(side, side, C)``, the mask head's transposed convs ``(in, out, 2, 2)``.
The work runs in blocks (images, query rows, prompts). Departures from the
published code: the object-score head is not run (the image predictor gates
no mask by it); windows must divide each block's grid (they do at the 1024
canvas), where SAM 2 would zero-pad. ``quant="fp8"`` puts every linear
layer's operands and the models' outputs on float8 steps, as ``sam.py``
does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .sam import BLOCK_BYTES, attention, fourier, image_pe, layer_norm, linear, mlp, up2x
from .yolo import out8


def blocks(t: Dict) -> List[Tuple[int, int, int, int, bool]]:
    """Every trunk block of the configuration's ``trunk`` group as (dim,
    dim_out, heads, window, pools): a stage's first block pools and doubles
    the width and the heads, and runs the previous stage's window."""
    ends = stage_ends(t)
    pools = [e + 1 for e in ends[:-1]][:t["q_pool"]]
    out, dim, heads, stage = [], t["embed_dim"], t["num_heads"], 0
    for i in range(sum(t["stages"])):
        window = 0 if i in t["global_att_blocks"] else t["window_spec"][stage]
        dim_out = dim
        if i - 1 in ends:
            dim_out, heads, stage = int(dim * t["dim_mul"]), int(heads * t["head_mul"]), stage + 1
        out.append((dim, dim_out, heads, window, i in pools))
        dim = dim_out
    return out


def stage_ends(t: Dict) -> List[int]:
    return [sum(t["stages"][:i + 1]) - 1 for i in range(len(t["stages"]))]


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of (N, S, S, C)."""
    n, s, _, c = x.shape
    return x.reshape(n, s // 2, 2, s // 2, 2, c).amax(dim=(2, 4))


def mha(q, k, v):
    """Softmax attention (N, heads, Lq, hd) x (N, heads, Lk, hd), the query
    rows in blocks that bound the logits held."""
    n, heads, lq, hd = q.shape
    lk = k.shape[2]
    rows = max(1, min(lq, BLOCK_BYTES // max(1, n * heads * lk * 4)))
    out = []
    for r0 in range(0, lq, rows):
        a = torch.softmax(q[:, :, r0:r0 + rows] @ k.transpose(-1, -2) * hd ** -0.5, -1)
        out.append(a @ v)
    return torch.cat(out, 2)


def block(x, p, dim, dim_out, heads, window, pool, eps, quant=None):
    """One Hiera block on x (B, S, S, dim) -> (B, S', S', dim_out)."""
    b, s, _, _ = x.shape
    h = layer_norm(x, p["ln1"], eps)
    shortcut = x
    if dim != dim_out:
        shortcut = linear(h, p["shortcut"], quant)
        if pool:
            shortcut = pool2(shortcut)
    w = window or s
    n = s // w
    hd = dim_out // heads
    qkv = linear(h, p["qkv"], quant).reshape(b, n, w, n, w, 3, heads, hd)
    qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7)  # (3, B, n, n, heads, w, w, hd)
    q = qkv[0].reshape(b * n * n * heads, w, w, hd)
    wq = w
    if pool:
        q, wq = pool2(q), w // 2
    q = q.reshape(b * n * n, heads, wq * wq, hd)
    k = qkv[1].reshape(b * n * n, heads, w * w, hd)
    v = qkv[2].reshape(b * n * n, heads, w * w, hd)
    o = mha(q, k, v).reshape(b, n, n, heads, wq, wq, hd).permute(0, 1, 4, 2, 5, 3, 6)
    x = shortcut + linear(o.reshape(b, n * wq, n * wq, dim_out), p["proj"], quant)
    m = F.gelu(linear(layer_norm(x, p["ln2"], eps), p["mlp1"], quant))
    return x + linear(m, p["mlp2"], quant)


def positions(v: Dict, side: int) -> torch.Tensor:
    """(1, side, side, C): the background table resized bicubically, plus the
    window table tiled (hieradet ``_get_pos_embed``); computed in fp32."""
    pe = F.interpolate(v["pos_embed"].float().permute(2, 0, 1)[None], size=(side, side),
                       mode="bicubic")
    win = v["pos_embed_window"].float().permute(2, 0, 1)[None]
    reps = side // win.shape[-1]
    return (pe + win.tile(1, 1, reps, reps)).permute(0, 2, 3, 1)


def encoder(v: Dict, cfg: Dict, pix: torch.Tensor, quant: Optional[str] = None):
    """(B, canvas, canvas, 3) normalised pixels -> (embedding (B, gs, gs, C),
    feat_s1 (B, 2 gs, 2 gs, C / 4), feat_s0 (B, 4 gs, 4 gs, C / 8)), in the
    type of the tree's weights."""
    t, nk = cfg["trunk"], cfg["neck"]
    dt = v["patch_embed"]["w"].dtype
    w = v["patch_embed"]["w"].permute(3, 2, 0, 1)
    x = F.conv2d(pix.to(dt).permute(0, 3, 1, 2), w, v["patch_embed"]["b"],
                 stride=t["patch_stride"], padding=t["patch_padding"]).permute(0, 2, 3, 1)
    x = x + positions(v, x.shape[1]).to(dt)
    feats = []
    ends = stage_ends(t)
    for i, (p, spec) in enumerate(zip(v["blocks"], blocks(t))):
        x = block(x, p, *spec, t["layer_norm_eps"], quant)
        if i in ends:
            feats.append(x)
    out: List[Optional[torch.Tensor]] = [None] * len(feats)
    prev = None
    for i in range(len(feats) - 1, -1, -1):
        lat = linear(feats[i], v["neck"]["lateral"][i], quant)
        if i in nk["fpn_top_down_levels"] and prev is not None:
            lat = lat + prev.repeat_interleave(2, 1).repeat_interleave(2, 2)
        out[i] = prev = lat
    kept = out[:len(out) - nk["scalp"]]
    emb = kept[-1] + v["no_mem_embed"]
    s1 = linear(kept[1], v["neck"]["conv_s1"], quant)
    s0 = linear(kept[0], v["neck"]["conv_s0"], quant)
    return tuple(out8(f, quant, (-1,)) for f in (emb, s1, s0))


def box_tokens(tree: Dict, boxes: torch.Tensor, canvas: int) -> torch.Tensor:
    """(N, 4) xyxy canvas pixels -> (N, 3, C): the corners as points labelled
    2 and 3 (their encodings plus ``point_embed`` 2, 3) and the padding
    point (``not_a_point``)."""
    pr = tree["prompt"]
    corners = fourier(tree["shared_pe"], (boxes + 0.5).reshape(-1, 2, 2) / canvas)
    corners = corners + pr["point_embed"][2:4].float()
    pad = pr["not_a_point"].float().expand(boxes.shape[0], 1, -1)
    return torch.cat([corners, pad], 1)


def decode(tree: Dict, emb: torch.Tensor, sparse: torch.Tensor, heads: int, eps: float,
           quant: Optional[str] = None):
    """The two-way transformer for N prompts on their images' embeddings
    (N, gs, gs, C), the output tokens [object score, IoU, masks] -> (every
    mask token's hypernetwork output (N, M, C / 8), the IoU head (N, M)
    before its sigmoid, the updated image tokens (N, gs, gs, C))."""
    d = tree["decoder"]
    n, gs, _, c = emb.shape
    kpe = image_pe(tree, gs, emb.device).to(emb.dtype)
    keys = (emb + tree["prompt"]["no_mask"]).reshape(n, gs * gs, c)
    out_tokens = torch.cat([d["obj_score_token"], d["iou_token"], d["mask_tokens"]], 0)
    qpe = torch.cat([out_tokens[None].expand(n, -1, -1), sparse.to(emb.dtype)], 1)
    queries = qpe
    for i, lp in enumerate(d["layers"]):
        if i == 0:
            queries = attention(lp["self_attn"], queries, queries, queries, heads, quant)
        else:
            q = queries + qpe
            queries = queries + attention(lp["self_attn"], q, q, queries, heads, quant)
        queries = layer_norm(queries, lp["ln1"], eps)
        queries = layer_norm(queries + attention(lp["t2i"], queries + qpe, keys + kpe, keys,
                                                 heads, quant), lp["ln2"], eps)
        h = linear(torch.relu(linear(queries, lp["mlp1"], quant)), lp["mlp2"], quant)
        queries = layer_norm(queries + h, lp["ln3"], eps)
        keys = layer_norm(keys + attention(lp["i2t"], keys + kpe, queries + qpe, queries, heads,
                                           quant), lp["ln4"], eps)
    queries = layer_norm(queries + attention(d["final_t2i"], queries + qpe, keys + kpe, keys,
                                             heads, quant), d["ln_final"], 1e-5)
    m = d["mask_tokens"].shape[0]
    hyper = torch.stack([mlp(d["hyper_mlps"][j], queries[:, 2 + j], quant) for j in range(m)], 1)
    return (out8(hyper, quant, (-1,)), mlp(d["iou_head"], queries[:, 1], quant),
            out8(keys, quant, (-1,)).reshape(n, gs, gs, c))


def mask_logits(tree: Dict, keys, s1, s0, hyper) -> torch.Tensor:
    """(N, g, g, C) image tokens with their images' high-resolution levels
    (N, 2g, 2g, C / 4), (N, 4g, 4g, C / 8) and the hypernetwork outputs (N,
    M, C / 8) -> (N, M, 4g, 4g) fp32 logits; the upscaling in the tokens'
    type, the products in fp32."""
    d = tree["decoder"]
    up = F.gelu(layer_norm(up2x(keys, d["up1_w"], d["up1_b"]) + s1, d["up_ln"], 1e-6))
    up = F.gelu(up2x(up, d["up2_w"], d["up2_b"]) + s0)
    return torch.einsum("nhwc,nmc->nmhw", up.float(), hyper.float())


def stability(logits0: torch.Tensor, delta: float) -> torch.Tensor:
    """Token 0's stability a prompt, logits (N, L, L) -> (N,): its pixels
    above +delta over its pixels above -delta (1 where none is)."""
    flat = logits0.flatten(1)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    return torch.where(area_u > 0, area_i / area_u.clamp(min=1.0), 1.0)


def single_mask(logits: torch.Tensor, iou: torch.Tensor, delta: float,
                thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The image predictor's choice (``_dynamic_multimask_via_stability``):
    logits (N, M, L, L), iou (N, M) -> (the chosen mask (N, L, L), its
    token (N,))."""
    stable = stability(logits[:, 0], delta) >= thresh
    best = iou[:, 1:].float().argmax(-1) + 1
    token = torch.where(stable, torch.zeros_like(best), best)
    return logits[torch.arange(logits.shape[0], device=logits.device), token], token


def step_bytes(gs: int, c: int) -> int:
    """Bytes a prompt holds at once in :func:`decode` and :func:`mask_logits`
    (fp32, a few copies)."""
    return max(gs * gs * max(c, 16 * 64), (4 * gs) ** 2 * (c // 8 + 4)) * 4 * 4

