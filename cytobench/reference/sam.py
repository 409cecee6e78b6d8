"""SAM in plain fp32, as the benchmarked pipeline uses it: the ViT image
encoder (windowed and global attention with decomposed relative positions,
then the neck), the box prompt encoder, the two-way mask decoder with a
single mask output, the mask head, and the bilinear resampling of a fixed
crop of frame pixels around each cell from the low-resolution logits.

Weights are the benchmark's tree (``cytobench/weights.py``): linear weights
``(in, out)``, the patch embedding and the neck's 3x3 conv HWIO, the mask
head's transposed convs ``(in, out, 2, 2)``. The work runs in blocks (images,
query rows, prompts) so that a whole batch at ViT-H fits beside nothing else.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .yolo import fake, out8

# logits held at once by the attention (bytes, fp32)
BLOCK_BYTES = 512 << 20


def layer_norm(x, p, eps: float):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def linear(x, p, quant: Optional[str] = None):
    """x @ w + b; ``quant="fp8"`` rounds x per token and w per output column
    to float8 steps first."""
    x, w = fake(x, p["w"], quant, (-1,), (0,))
    return x @ w + p["b"]


def rel_table(rel: torch.Tensor, w: int) -> torch.Tensor:
    """(2w - 1, hd) -> (w, w, hd): entry [q, k] = rel[q - k + w - 1]."""
    idx = torch.arange(w, device=rel.device)
    return rel[idx[:, None] - idx[None, :] + w - 1]


def window_attention(q, k, v, rel_h, rel_w):
    """Attention inside square windows with SAM's decomposed relative
    positions. q, k, v (N, heads, w, w, hd) -> (N, heads, w, w, hd); the
    position terms use the unscaled query."""
    n, heads, w, _, hd = q.shape
    th, tw = rel_table(rel_h, w), rel_table(rel_w, w)
    rows = max(1, min(w, BLOCK_BYTES // max(1, n * heads * w * w * w * 4)))
    out = []
    for r0 in range(0, w, rows):
        qb = q[:, :, r0:r0 + rows]
        logits = torch.einsum("nhyxd,nhkld->nhyxkl", qb * hd ** -0.5, k)
        rh = torch.einsum("nhyxd,ykd->nhyxk", qb, th[r0:r0 + rows])
        rw = torch.einsum("nhyxd,xkd->nhyxk", qb, tw)
        logits = logits + rh[..., :, None] + rw[..., None, :]
        shape = logits.shape
        p = torch.softmax(logits.reshape(*shape[:-2], w * w), -1).reshape(shape)
        out.append(torch.einsum("nhyxkl,nhkld->nhyxd", p, v))
    return torch.cat(out, 2)


def encoder_layer(x, p, heads: int, window: int, quant: Optional[str] = None):
    """One ViT layer on x (B, S, S, C): attention in windows of ``window``
    (the whole grid for a global layer), then the MLP, each residual."""
    b, s, _, c = x.shape
    hd = c // heads
    nw = s // window
    h = layer_norm(x, p["ln1"], 1e-6)
    qkv = linear(h, p["attn"]["qkv"], quant)
    qkv = qkv.reshape(b, nw, window, nw, window, 3, heads, hd)
    qkv = qkv.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, b * nw * nw, heads, window, window, hd)
    o = window_attention(qkv[0], qkv[1], qkv[2], p["attn"]["rel_pos_h"], p["attn"]["rel_pos_w"])
    o = o.reshape(b, nw, nw, heads, window, window, hd).permute(0, 1, 4, 2, 5, 3, 6)
    x = x + linear(o.reshape(b, s, s, c), p["attn"]["proj"], quant)
    h = F.gelu(linear(layer_norm(x, p["ln2"], 1e-6), p["mlp1"], quant))
    return x + linear(h, p["mlp2"], quant)


def encoder(v: Dict, cfg: Dict, pix: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """(B, canvas, canvas, 3) normalised pixels -> (B, gs, gs, out_channels),
    computed in the type of the tree's weights."""
    ps = cfg["patch_size"]
    pix = pix.to(v["patch_embed"]["w"].dtype)
    b, hgt, wid, _ = pix.shape
    gs = hgt // ps
    patches = pix.reshape(b, gs, ps, gs, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, gs, gs, -1)
    x = patches @ v["patch_embed"]["w"].reshape(-1, cfg["hidden_size"]) + v["patch_embed"]["b"]
    x = x + v["pos_embed"]
    for i, p in enumerate(v["layers"]):
        window = gs if i in cfg["global_attn_indexes"] else cfg["window_size"]
        x = encoder_layer(x, p, cfg["num_attention_heads"], window, quant)
    n = v["neck"]
    y = layer_norm(x @ n["conv1_w"], n["ln1"], 1e-6)
    y = F.conv2d(y.permute(0, 3, 1, 2), n["conv2_w"].permute(3, 2, 0, 1), padding=1)
    return out8(layer_norm(y.permute(0, 2, 3, 1), n["ln2"], 1e-6), quant, (-1,))


def fourier(gauss: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """SAM's random-Fourier position encoding of coords in [0, 1]^2, in fp32
    (the sines' arguments reach hundreds of radians)."""
    proj = 2.0 * math.pi * ((2.0 * coords01.float() - 1.0) @ gauss.float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


def box_tokens(tree: Dict, boxes: torch.Tensor, canvas: int) -> torch.Tensor:
    """(N, 4) xyxy canvas pixels -> (N, 2, C): the two corners' encodings
    plus the corner embeddings."""
    corners = (boxes + 0.5).reshape(-1, 2, 2) / canvas
    pe = fourier(tree["shared_pe"], corners)
    return pe + tree["prompt"]["point_embed"][2:4].float()


def image_pe(tree: Dict, gs: int, device) -> torch.Tensor:
    """(gs * gs, C) encoding of the token grid's cell centres, (x, y) order."""
    t = (torch.arange(gs, device=device, dtype=torch.float32) + 0.5) / gs
    grid = torch.stack([t[None, :].expand(gs, gs), t[:, None].expand(gs, gs)], -1)
    return fourier(tree["shared_image_pe"], grid).reshape(gs * gs, -1)


def attention(p: Dict, q, k, v, heads: int, quant: Optional[str] = None):
    """SAM's decoder attention (N, Tq, C), (N, Tk, C) -> (N, Tq, C)."""
    qp, kp, vp = linear(q, p["q"], quant), linear(k, p["k"], quant), linear(v, p["v"], quant)
    n, tq, d = qp.shape
    hd = d // heads
    split = lambda t: t.reshape(n, -1, heads, hd).transpose(1, 2)  # noqa: E731
    a = torch.softmax(split(qp) @ split(kp).transpose(-1, -2) * hd ** -0.5, -1)
    return linear((a @ split(vp)).transpose(1, 2).reshape(n, tq, d), p["out"], quant)


def mlp(p: Dict, x, quant: Optional[str] = None):
    x = torch.relu(linear(x, p["in"], quant))
    for h in p["hidden"]:
        x = torch.relu(linear(x, h, quant))
    return linear(x, p["out"], quant)


def decode(tree: Dict, emb: torch.Tensor, sparse: torch.Tensor, heads: int = 8,
           quant: Optional[str] = None):
    """The two-way transformer for N prompts on their images' embeddings
    emb (N, gs, gs, C) -> (the first mask token's hypernetwork output (N,
    C / 8), the updated image tokens (N, gs, gs, C)). ``quant`` puts every
    linear layer on its steps (``linear``)."""
    d = tree["decoder"]
    n, gs, _, c = emb.shape
    kpe = image_pe(tree, gs, emb.device).to(emb.dtype)
    sparse = sparse.to(emb.dtype)
    keys = (emb + tree["prompt"]["no_mask"]).reshape(n, gs * gs, c)
    out_tokens = torch.cat([d["iou_token"], d["mask_tokens"]], 0)
    qpe = torch.cat([out_tokens[None].expand(n, -1, -1), sparse], 1)
    queries = qpe
    for i, lp in enumerate(d["layers"]):
        if i == 0:
            queries = attention(lp["self_attn"], queries, queries, queries, heads, quant)
        else:
            q = queries + qpe
            queries = queries + attention(lp["self_attn"], q, q, queries, heads, quant)
        queries = layer_norm(queries, lp["ln1"], 1e-6)
        queries = layer_norm(queries + attention(lp["t2i"], queries + qpe, keys + kpe, keys,
                                                 heads, quant), lp["ln2"], 1e-6)
        h = linear(torch.relu(linear(queries, lp["mlp1"], quant)), lp["mlp2"], quant)
        queries = layer_norm(queries + h, lp["ln3"], 1e-6)
        keys = layer_norm(keys + attention(lp["i2t"], keys + kpe, queries + qpe, queries, heads, quant),
                          lp["ln4"], 1e-6)
    queries = layer_norm(queries + attention(d["final_t2i"], queries + qpe, keys + kpe, keys,
                                             heads, quant), d["ln_final"], 1e-5)
    return (out8(mlp(d["hyper_mlps"][0], queries[:, 1], quant), quant, (-1,)),
            out8(keys, quant, (-1,)).reshape(n, gs, gs, c))


def up2x(x, w, b):
    """2x2 stride-2 transposed conv of (N, g, g, Ci), w (Ci, Co, 2, 2)."""
    n, g, _, _ = x.shape
    y = torch.einsum("nhwc,coij->nhiwjo", x, w)
    return y.reshape(n, 2 * g, 2 * g, w.shape[1]) + b


def mask_logits(tree: Dict, keys: torch.Tensor, hyper: torch.Tensor) -> torch.Tensor:
    """(N, g, g, C) image tokens, (N, C / 8) -> (N, 4g, 4g) fp32 mask
    logits; the upscaling in the tokens' type, the products in fp32."""
    d = tree["decoder"]
    up = F.gelu(layer_norm(up2x(keys, d["up1_w"], d["up1_b"]), d["up_ln"], 1e-6))
    up = F.gelu(up2x(up, d["up2_w"], d["up2_b"]))
    return torch.einsum("nhwc,nc->nhw", up.float(), hyper.float())


def crop_sample(low: torch.Tensor, offsets: torch.Tensor, crop: int, scale: float):
    """Bilinear samples of low-resolution logits (N, L, L) at a crop x crop
    block of frame pixels from ``offsets`` (N, 2): frame pixel r maps to
    (r + 0.5) * scale - 0.5, clamped to the map."""
    n, size, _ = low.shape
    idx = torch.arange(crop, device=low.device, dtype=torch.float32)

    def axis(off):
        pos = ((off[:, None].float() + idx + 0.5) * scale - 0.5).clamp(0.0, size - 1.0)
        lo = pos.floor().long()
        return lo, (lo + 1).clamp(max=size - 1), pos - lo

    y0, y1, wy = axis(offsets[:, 0])
    x0, x1, wx = axis(offsets[:, 1])
    nn = torch.arange(n, device=low.device)[:, None, None]
    at = lambda ys, xs: low[nn, ys[:, :, None], xs[:, None, :]]  # noqa: E731
    top = at(y0, x0) * (1 - wx[:, None, :]) + at(y0, x1) * wx[:, None, :]
    bot = at(y1, x0) * (1 - wx[:, None, :]) + at(y1, x1) * wx[:, None, :]
    return top * (1 - wy[:, :, None]) + bot * wy[:, :, None]
