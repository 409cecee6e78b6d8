"""Window attention with SAM's decomposed rel-pos bias (kernels K2 + K3).

Counterpart of ``relpos_tables`` and ``flash_attention_grid`` in
``yolo_sam_inference_tpu/ops/flash_attention.py``. On the card one CUDA
kernel (``csrc/window_attn_relpos.cu``) does both: it multiplies each query
by the raw ``(2w-1, hd)`` tables inside the block, and runs the window
attention with an online fp32 softmax. Its source note says what
bounds it and what the design does about it. The output projection, fused
into the TPU kernel, follows here as a GEMM (``ops.fused_ln.linear``).

Layout at the public function is the JAX package's: the fused qkv
``(B, S, S, 3C)`` with channels ``[q | k | v]``, head-major inside each, and
the output ``(B, S, S, C)``. Attention is confined to non-overlapping
``window x window`` blocks of the grid (``window = S`` for global layers).

Dispatch is by the tensor's device: CPU takes the plain version, CUDA
launches the kernel or raises. ``window_attention.launches`` counts launches,
and ``window_attention.by_window`` counts them per window size.
"""

from __future__ import annotations

import torch

from ._build import check, kernels
from .fused_ln import _on_cpu


# What the kernel is built for: ViT-B/L (hd 64) and ViT-H (hd 80), windowed
# layers (16) and the global layers of the 32 x 32, 48 x 48 and 64 x 64 grids
# (the 512, 768 and 1024 canvases).
KERNEL_HEAD_DIMS = (64, 80)
KERNEL_WINDOWS = (16, 32, 48, 64)
# fp32 logits the plain version holds at once (bytes): larger batches run in
# slices of images (one image at w = 64 and 16 heads is 1 GiB)
_PLAIN_LOGIT_BYTES = 2 << 30


def window_attention_plain(qkv, rel_h, rel_w, heads: int, window: int):
    """fp32 einsum/softmax version of :func:`window_attention` (output in
    qkv's dtype). Logits use ``q * hd^-0.5``; the rel-pos terms use the
    unscaled q, as SAM does."""
    b, s = qkv.shape[0], qkv.shape[1]
    per_image = heads * s * s * window * window * 4
    step = max(1, _PLAIN_LOGIT_BYTES // per_image)
    if b > step:
        return torch.cat([_window_attention_plain(qkv[i:i + step], rel_h, rel_w, heads, window)
                          for i in range(0, b, step)])
    return _window_attention_plain(qkv, rel_h, rel_w, heads, window)


def _window_attention_plain(qkv, rel_h, rel_w, heads: int, window: int):
    b, s, _, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    w = window
    nw = s // w
    t = qkv.float().reshape(b, nw, w, nw, w, 3, heads, hd)
    t = t.permute(5, 0, 1, 3, 6, 2, 4, 7)  # (3, b, wy, wx, head, y, x, hd)
    q, k, v = t[0], t[1], t[2]
    idx = torch.arange(w)[:, None] - torch.arange(w)[None, :] + w - 1
    idx = idx.to(qkv.device)
    rh_tab = rel_h.float()[idx]  # (q_local, k_local, hd)
    rw_tab = rel_w.float()[idx]
    rh = torch.einsum("...yxd,ykd->...yxk", q, rh_tab)
    rw = torch.einsum("...yxd,xkd->...yxk", q, rw_tab)
    logits = torch.einsum("...yxd,...kld->...yxkl", q * hd ** -0.5, k)
    logits = logits + rh[..., :, None] + rw[..., None, :]
    shape = logits.shape
    p = torch.softmax(logits.reshape(*shape[:-2], w * w), dim=-1).reshape(shape)
    o = torch.einsum("...yxkl,...kld->...yxd", p, v)  # (b, wy, wx, head, y, x, hd)
    o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(b, s, s, c)
    return o.to(qkv.dtype)


def window_attention(qkv, rel_h, rel_w, heads: int, window: int):
    """(B, S, S, 3C) fused qkv + raw (2w-1, hd) rel-pos tables -> (B, S, S, C).

    The kernel takes all three in bf16, as the pipeline's weights are."""
    b, s, s2, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    if s != s2 or c3 != 3 * c or c != heads * hd or s % window:
        raise ValueError(f"window_attention: bad geometry {tuple(qkv.shape)}, "
                         f"heads={heads}, window={window}")
    if tuple(rel_h.shape) != (2 * window - 1, hd) or rel_w.shape != rel_h.shape:
        raise ValueError(f"window_attention: rel-pos tables {tuple(rel_h.shape)}, "
                         f"need {(2 * window - 1, hd)}")
    if _on_cpu(qkv):
        return window_attention_plain(qkv, rel_h, rel_w, heads, window)
    if hd not in KERNEL_HEAD_DIMS or window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention kernel takes hd=64 or hd=80 with window 16, 32, 48 "
                         f"or 64; got hd={hd}, window={window}")
    for name, t in (("qkv", qkv), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != qkv.device:
            raise ValueError(f"window_attention kernel: {name} must be contiguous bf16 on "
                             f"{qkv.device}, got {t.dtype} on {t.device}")
    out = torch.empty((b, s, s, c), dtype=torch.bfloat16, device=qkv.device)
    err = kernels().ysi_window_attn_relpos(
        qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
        b, s, heads, hd, window, torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    check(err, "window_attention")
    window_attention.launches += 1
    window_attention.by_window[window] = window_attention.by_window.get(window, 0) + 1
    return out


window_attention.launches = 0
window_attention.by_window = {}  # launches per window size
