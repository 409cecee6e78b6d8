"""SAM's attention with the decomposed rel-pos bias: the window attention
of the grid route (kernels K2 + K3) and the k-tiled attention of the flat
and sequence-parallel routes (K12).

Counterpart of ``relpos_tables``, ``flash_attention_grid`` and
``flash_attention_relpos`` in ``yolo_sam_inference_tpu/ops/flash_attention.py``.

:func:`window_attention`: on the card K12's kernel
(``csrc/flash_attention_relpos.cu``) does K2 and K3 in its window mode: one
block takes a query tile of one window, image and head, reads q, k and v in
place from the fused qkv through tensor maps at the window's origin,
multiplies its queries by the raw ``(2w-1, hd)`` tables inside the block,
and runs the attention on wgmma with an online fp32 softmax; at ``window =
S`` (the global layers) it is K12's whole-grid case. Windows of 16 run on
``csrc/window_attn_relpos.cu`` (mma.sync, several small blocks an SM),
which is faster there; its source note says why. The output projection,
fused into the TPU kernel, follows here as a GEMM (``ops.fused_ln.linear``).

Layout at the public function is the JAX package's: the fused qkv
``(B, S, S, 3C)`` with channels ``[q | k | v]``, head-major inside each, and
the output ``(B, S, S, C)``. Attention is confined to non-overlapping
``window x window`` blocks of the grid (``window = S`` for global layers).

Dispatch is by the tensor's device: CPU takes the plain version, CUDA
launches the kernel or raises; where autograd records a CUDA call, through
``ops/autograd.py`` (the plain version's autograd as backward). ``window_attention.launches`` counts launches,
and ``window_attention.by_window`` counts them per window size; K12's
counts do not include them.

:func:`flash_attention_relpos` (K12) takes q ``(B, NQ, C)`` and k, v
``(B, N, C)`` over an ``S x S`` key grid (``N = S^2``, ``C = heads * hd``)
as strided views with contiguous channels, e.g. the thirds of the fused
qkv, and the raw ``(2S-1, hd)`` rel-pos tables; the queries are whole grid
rows from absolute row ``row0`` (a sequence-parallel rank holds only some
of the rows). On the card it launches ``csrc/flash_attention_relpos.cu``,
which reads q, k and v in place and builds the rel-pos terms inside;
``flash_attention_relpos.launches`` counts launches and ``.by_nq`` counts
them per query count. Its plain version, :func:`relpos_attention_plain`,
composes :func:`relpos_score_tables` (the fp32 ``(BH, NQ, S)`` tables, as
the JAX package builds them) and :func:`flash_attention_relpos_plain`.
:func:`relpos_grid_attention` takes the fused qkv layout of
:func:`window_attention` and runs K12 over each whole grid of the batch:
the flat route's grids and windows, and a sequence-parallel rank's windows
of ``K12_WINDOW``.
"""

from __future__ import annotations

import torch

from ._build import check, kernels
from .autograd import through_kernel, wants_grad
from .fused_ln import _on_cpu


# What the kernel is built for: ViT-B/L (hd 64) and ViT-H (hd 80), windowed
# layers (16) and the global layers of the 32 x 32, 48 x 48 and 64 x 64 grids
# (the 512, 768 and 1024 canvases).
KERNEL_HEAD_DIMS = (64, 80)
KERNEL_WINDOWS = (16, 32, 48, 64)
# SAM's native window, which the window attention kernel does not take: on
# every device, windows of this size run on K12 (:func:`relpos_grid_attention`)
K12_WINDOW = 14
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
    if wants_grad(qkv, rel_h, rel_w):
        return through_kernel(window_attention, window_attention_plain, qkv, rel_h, rel_w, heads,
                              window)
    if hd not in KERNEL_HEAD_DIMS or window not in KERNEL_WINDOWS:
        raise ValueError(f"window_attention kernel takes hd=64 or hd=80 with window 16, 32, 48 "
                         f"or 64; got hd={hd}, window={window}")
    for name, t in (("qkv", qkv), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != qkv.device:
            raise ValueError(f"window_attention kernel: {name} must be contiguous bf16 on "
                             f"{qkv.device}, got {t.dtype} on {t.device}")
    if window == 16:  # the windowed layers
        out = torch.empty((b, s, s, c), dtype=torch.bfloat16, device=qkv.device)
        check(kernels().ysi_window_attn_relpos(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(), b, s, heads, hd,
            window, torch.cuda.current_stream(qkv.device).cuda_stream), "window_attention")
    else:
        flat = qkv.reshape(b, s * s, c3)
        out = _relpos_kernel(flat[..., :c], flat[..., c:2 * c], flat[..., 2 * c:], rel_h, rel_w,
                             s, 0, window if window < s else 0, "window_attention")
    window_attention.launches += 1
    window_attention.by_window[window] = window_attention.by_window.get(window, 0) + 1
    return out.reshape(b, s, s, c)


window_attention.launches = 0
window_attention.by_window = {}  # launches per window size


# ------------------------------------------------------------------------- K12

# The grid sides S the K12 kernel takes: its key tiles are whole key rows of
# S rounded up to 8, and it builds the q.R terms of up to 2S-1 table rows.
RELPOS_MAX_GRID = 64


def relpos_score_tables(q, rel_h, rel_w, s: int, row0: int = 0):
    """The decomposed rel-pos score tables of K12, fp32 ``(BH, NQ, S)`` each.

    ``q`` (BH, NQ, hd) holds NQ / S whole rows of the S x S grid, unscaled,
    starting at absolute grid row ``row0`` (a sequence-parallel rank's first
    row; 0 for the whole grid). ``rel_h``, ``rel_w`` are the raw
    ``(2S-1, hd)`` tables. ``rh[i, ky] = q_i . rel_h[y_i - ky + S - 1]`` and
    ``rw[i, kx] = q_i . rel_w[x_i - kx + S - 1]``, as JAX
    ``models/sam/model.py:230-236`` and ``parallel/sp.py:145-164`` build them
    (there with XLA einsums, here with torch products)."""
    bh, nq, hd = q.shape
    if nq % s or row0 < 0 or row0 + nq // s > s:
        raise ValueError(f"relpos_score_tables: {nq} queries from row {row0} are not whole "
                         f"rows of a {s} x {s} grid")
    dev = q.device
    rows = torch.arange(nq // s, device=dev) + row0
    cols = torch.arange(s, device=dev)
    th = rel_h.float()[rows[:, None] - cols[None, :] + s - 1]  # (rows, S, hd) [qy, ky]
    tw = rel_w.float()[cols[:, None] - cols[None, :] + s - 1]  # (S, S, hd) [qx, kx]
    qg = q.float().reshape(bh, nq // s, s, hd)
    rh = torch.einsum("byxc,ykc->byxk", qg, th).reshape(bh, nq, s)
    rw = torch.einsum("byxc,xkc->byxk", qg, tw).reshape(bh, nq, s)
    return rh.contiguous(), rw.contiguous()


def flash_attention_relpos_plain(q, k, v, rh, rw, grid_s: int):
    """K12's attention in fp32 given its score tables (output in v's dtype):
    q ``(BH, NQ, hd)``, k, v ``(BH, N, hd)``, rh, rw ``(BH, NQ, S)`` from
    :func:`relpos_score_tables`;
    ``softmax(q.k^T hd^-0.5 + rh[:, :, j // S] + rw[:, :, j % S]) . v``."""
    bh, nq, hd = q.shape
    n = k.shape[1]
    step = max(1, _PLAIN_LOGIT_BYTES // (nq * n * 4))
    out = []
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        logits = (q[sl].float() * hd ** -0.5) @ k[sl].float().transpose(1, 2)
        bias = rh[sl].float()[..., :, None] + rw[sl].float()[..., None, :]  # (b, NQ, ky, kx)
        p = torch.softmax(logits + bias.reshape(logits.shape), dim=-1)
        out.append(p @ v[sl].float())
    return torch.cat(out).to(v.dtype)


def _heads_major(t, heads: int):
    """(B, T, heads * hd) -> (B * heads, T, hd)."""
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2).reshape(b * heads, n, c // heads)


def relpos_attention_plain(q, k, v, rel_h, rel_w, grid_s: int, row0: int = 0):
    """fp32 version of :func:`flash_attention_relpos` (output in v's dtype):
    the score tables by :func:`relpos_score_tables`, the attention by
    :func:`flash_attention_relpos_plain`."""
    b, nq, c = q.shape
    heads = c // rel_h.shape[-1]
    qh = _heads_major(q, heads)
    rh, rw = relpos_score_tables(qh, rel_h, rel_w, grid_s, row0=row0)
    o = flash_attention_relpos_plain(qh, _heads_major(k, heads), _heads_major(v, heads), rh, rw,
                                     grid_s)
    return o.reshape(b, heads, nq, -1).transpose(1, 2).reshape(b, nq, c)


def _image_stride(t) -> int:
    """Elements between images of a (B, T, C) view (any value where B is 1)."""
    return t.stride(0) if t.shape[0] > 1 else t.shape[1] * t.stride(1)


def flash_attention_relpos(q, k, v, rel_h, rel_w, grid_s: int, row0: int = 0):
    """K12: attention of q ``(B, NQ, C)``, whole grid rows from absolute row
    ``row0``, over the ``grid_s^2`` keys of k, v ``(B, N, C)`` with SAM's
    decomposed rel-pos bias from the raw ``(2 grid_s - 1, hd)`` tables
    (``C = heads * hd``, hd from the tables); softmax in fp32, output
    ``(B, NQ, C)`` in v's dtype, contiguous.

    The kernel takes bf16 everywhere, hd 64 or 80, grid_s up to 64; q, k and
    v may be strided views (the thirds of a fused qkv) with contiguous
    channels, token and image strides multiples of 8 elements and k, v of
    the same strides."""
    b, nq, c = q.shape
    hd = rel_h.shape[-1]
    n = grid_s * grid_s
    if (tuple(k.shape) != (b, n, c) or tuple(v.shape) != (b, n, c) or c % hd
            or nq % grid_s or row0 < 0 or row0 + nq // grid_s > grid_s):
        raise ValueError(f"flash_attention_relpos: q {tuple(q.shape)} from row {row0}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} on a {grid_s} x {grid_s} "
                         f"grid at hd {hd}")
    if tuple(rel_h.shape) != (2 * grid_s - 1, hd) or rel_w.shape != rel_h.shape:
        raise ValueError(f"flash_attention_relpos: rel-pos tables {tuple(rel_h.shape)}, "
                         f"{tuple(rel_w.shape)}, need {(2 * grid_s - 1, hd)}")
    if _on_cpu(q):
        return relpos_attention_plain(q, k, v, rel_h, rel_w, grid_s, row0)
    if wants_grad(q, k, v, rel_h, rel_w):
        return through_kernel(flash_attention_relpos, relpos_attention_plain, q, k, v, rel_h,
                              rel_w, grid_s, row0)
    if hd not in KERNEL_HEAD_DIMS or grid_s > RELPOS_MAX_GRID:
        raise ValueError(f"flash_attention_relpos kernel takes hd=64 or hd=80 and a grid side "
                         f"up to {RELPOS_MAX_GRID}; got hd={hd}, grid_s={grid_s}")
    out = _relpos_kernel(q, k, v, rel_h, rel_w, grid_s, row0, 0, "flash_attention_relpos")
    flash_attention_relpos.launches += 1
    flash_attention_relpos.by_nq[nq] = flash_attention_relpos.by_nq.get(nq, 0) + 1
    return out


flash_attention_relpos.launches = 0
flash_attention_relpos.by_nq = {}  # launches per query count NQ


def _relpos_kernel(q, k, v, rel_h, rel_w, grid_s: int, row0: int, window: int, who: str):
    """Launch ``csrc/flash_attention_relpos.cu`` on checked geometry: the
    whole-grid mode (``window`` 0) or the window mode. Checks what the kernel
    needs of the tensors, then returns the (B, NQ, C) output; counts nothing."""
    b, nq, c = q.shape
    hd = rel_h.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v), ("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dtype != torch.bfloat16 or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(f"{who} kernel: {name} must be bf16 on {q.device} with contiguous "
                             f"channels, got {t.dtype} on {t.device}, strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{who} kernel: {name} is not 16-byte aligned")
    if not (rel_h.is_contiguous() and rel_w.is_contiguous()):
        raise ValueError(f"{who} kernel: the rel-pos tables must be contiguous")
    if k.stride() != v.stride():
        raise ValueError(f"{who} kernel: k and v strides differ: {k.stride()}, {v.stride()}")
    strides = (q.stride(1), _image_stride(q), k.stride(1), _image_stride(k))
    if any(st % 8 for st in strides):
        raise ValueError(f"{who} kernel: token and image strides {strides} must be multiples "
                         f"of 8 elements")
    out = torch.empty((b, nq, c), dtype=torch.bfloat16, device=q.device)
    err = kernels().ysi_flash_attn_relpos(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
        out.data_ptr(), b, c // hd, nq, grid_s, row0, hd, *strides, window,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, who)
    return out


def relpos_grid_attention(qkv, rel_h, rel_w, heads: int, plain: bool = False):
    """(B, S, S, 3C) fused qkv + raw (2S-1, hd) rel-pos tables -> (B, S, S, C):
    attention over all S x S tokens of each grid of the batch on K12 (a whole
    token grid, or a batch of windows), q, k and v read in place from qkv.
    ``plain`` takes K12's plain version on any device."""
    b, s, _, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c != heads * rel_h.shape[-1]:
        raise ValueError(f"relpos_grid_attention: qkv {tuple(qkv.shape)} is not 3 x {heads} "
                         f"heads of {rel_h.shape[-1]}")
    flat = qkv.reshape(b, s * s, c3)
    attn = relpos_attention_plain if plain else flash_attention_relpos
    o = attn(flat[..., :c], flat[..., c:2 * c], flat[..., 2 * c:], rel_h, rel_w, s)
    return o.reshape(b, s, s, c)
