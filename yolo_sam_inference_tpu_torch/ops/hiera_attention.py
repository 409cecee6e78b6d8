"""SAM 2's Hiera attention: softmax(q k^T / sqrt(hd)) v in square windows of
the token grid (or over the whole grid), the queries max-pooled 2 x 2 inside
each window at a stage's first block. No relative-position bias.

:func:`hiera_window_attention` takes the qkv GEMM's output ``(B, S, S, 3C)``
(channels ``[q | k | v]``, head-major inside each) and returns ``(B, S', S',
C)`` in token order (``S' = S / 2`` where the queries pool), the output
projection's A operand. The tokens of qkv may lie further apart than 3C
elements: at a pooling block it is the first 3C columns of the ``[qkv |
shortcut]`` product, a view whose rows are 4C apart, and it is read as it is.

On the card it launches ``csrc/hiera_attention.cu``, which reads each
window's q, k and v in place, pools the queries as they load and writes the
output in token order: no window copies and no library attention. The kernel
takes bf16 at hd 72 (every block of Hiera-L) and window sides whose windows
hold 16 keys or a multiple of 64.

Dispatch is by the tensor's device: CPU takes the plain version, CUDA
launches the kernel or raises; where autograd records a CUDA call, through
``ops/autograd.py`` (the plain version's autograd as backward).
``hiera_window_attention.launches`` counts launches and ``.by_window``
counts them per case: (grid side, window side, pool), window 0 for a global
block, the cases of ``Sam2Config.attention()``.
"""

from __future__ import annotations

import torch

from ._build import check, kernels
from .autograd import through_kernel, wants_grad
from .fused_ln import _on_cpu

KERNEL_HEAD_DIM = 72
# fp32 logits the plain version holds at once (bytes): larger batches of
# windows run in slices
_PLAIN_LOGIT_BYTES = 1 << 30


def _geometry(qkv, heads: int, window: int, pool: bool):
    """(b, s, c, hd, w) of a checked call; ``window`` 0 is the whole grid."""
    if qkv.dim() != 4 or qkv.shape[1] != qkv.shape[2]:
        raise ValueError(f"hiera_window_attention: qkv must be (B, S, S, 3C), got "
                         f"{tuple(qkv.shape)}")
    b, s, _, c3 = qkv.shape
    c = c3 // 3
    w = window or s
    if c3 != 3 * c or heads <= 0 or c % heads or s % w or (pool and w % 2):
        raise ValueError(f"hiera_window_attention: window {w} (pool {pool}) on qkv "
                         f"{tuple(qkv.shape)} with {heads} heads")
    return b, s, c, c // heads, w


def hiera_window_attention_plain(qkv, heads: int, window: int, pool: bool):
    """fp32 version of :func:`hiera_window_attention` (output in qkv's
    dtype): each window's q (max-pooled 2 x 2 with ``pool``), k and v
    gathered, then ``softmax(q k^T * hd^-0.5) v`` written out."""
    b, s, c, hd, w = _geometry(qkv, heads, window, pool)
    n = s // w
    wq = w // 2 if pool else w
    # (3, B, n, n, heads, w, w, hd): each window's tokens, by head
    t = qkv.float().reshape(b, n, w, n, w, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = t[0], t[1], t[2]
    if pool:
        q = q.reshape(b, n, n, heads, wq, 2, wq, 2, hd).amax(dim=(-4, -2))
    q = q.reshape(b * n * n, heads, wq * wq, hd)
    k = k.reshape(b * n * n, heads, w * w, hd)
    v = v.reshape(b * n * n, heads, w * w, hd)
    step = max(1, _PLAIN_LOGIT_BYTES // (heads * wq * wq * w * w * 4))
    o = torch.cat([torch.softmax((q[i:i + step] @ k[i:i + step].transpose(-1, -2)) * hd ** -0.5,
                                 dim=-1) @ v[i:i + step] for i in range(0, b * n * n, step)])
    o = o.reshape(b, n, n, heads, wq, wq, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, n * wq, n * wq, c).to(qkv.dtype)


def hiera_window_attention(qkv, heads: int, window: int, pool: bool):
    """(B, S, S, 3C) qkv -> (B, S', S', C): attention in windows of
    ``window`` tokens a side (0: the whole grid), the queries pooled 2 x 2
    first with ``pool``.

    The kernel takes bf16 qkv with contiguous channels, tokens a multiple of
    8 elements apart in row-major order (a column slice of a wider product
    is fine), hd 72, and windows of 16 keys or a multiple of 64."""
    b, s, c, hd, w = _geometry(qkv, heads, window, pool)
    if _on_cpu(qkv):
        return hiera_window_attention_plain(qkv, heads, window, pool)
    if wants_grad(qkv):
        return through_kernel(hiera_window_attention, hiera_window_attention_plain, qkv, heads,
                              window, pool)
    if hd != KERNEL_HEAD_DIM or (w * w != 16 and w * w % 64):
        raise ValueError(f"hiera_window_attention kernel takes hd {KERNEL_HEAD_DIM} and windows "
                         f"of 16 keys or a multiple of 64; got hd={hd}, window={w}")
    rs = qkv.stride(2)
    if (qkv.dtype != torch.bfloat16 or qkv.stride(3) != 1 or rs % 8 or rs < 3 * c
            or qkv.stride(1) != s * rs or (b > 1 and qkv.stride(0) != s * s * rs)
            or qkv.data_ptr() % 16):
        raise ValueError(f"hiera_window_attention kernel: qkv must be 16-byte aligned bf16 with "
                         f"row-major tokens a multiple of 8 elements apart, got {qkv.dtype}, "
                         f"strides {qkv.stride()}")
    so = s // 2 if pool else s
    out = torch.empty((b, so, so, c), dtype=torch.bfloat16, device=qkv.device)
    check(kernels().ysi_hiera_attention(
        qkv.data_ptr(), out.data_ptr(), b, s, heads, hd, window, int(pool), rs,
        torch.cuda.current_stream(qkv.device).cuda_stream), "hiera_window_attention")
    hiera_window_attention.launches += 1
    key = (s, window, bool(pool))
    hiera_window_attention.by_window[key] = hiera_window_attention.by_window.get(key, 0) + 1
    return out


hiera_window_attention.launches = 0
hiera_window_attention.by_window = {}  # launches per (grid, window, pool); window 0: global
