"""TinyViT window attention block (kernel K13).

Counterpart of ``tinyvit_window_block`` and ``tinyvit_window_block_cells`` in
``yolo_sam_inference_tpu/ops/tinyvit_attention.py``: one function,
``x + proj(attn(LN(pad(x))) + learned bias)`` over non-overlapping
``ws x ws`` windows (ws 7 or 14, head dim 32), whose two TPU forms differ only
in how the windows are laid out in VMEM.

On the card, at TinyViT-5M's stages 1 and 2 (:data:`KERNEL_WIDTHS`), it is
one launch of ``csrc/tinyvit_block.cu``: a window's tokens gathered and
normalised in shared memory, qkv a head at a time on the tensor cores, the
window attention with the learned per-offset bias (from the raw
``(heads, (2ws-1)^2)`` table, fp32 softmax), the projection and the residual;
qkv and the attention output never reach device memory. :func:`block_plan`
says how a width is laid out, :func:`block_schedule` which warpgroup takes
which window, :func:`real_query_tiles` which of a window's 64-query tiles it
computes. At stage 3 (C 320 at ws 7), where the one-launch kernel lost in
turns, it is three: ``gemm_bf16`` with its LayerNorm (LN + qkv on the
unpadded tokens), :func:`tinyvit_attention` (``csrc/tinyvit_attn.cu``) and
``gemm_bf16`` (the projection with the residual).

Spatial padding. The official TinyViT pads the pre-norm input with zeros and
normalises after windowing, so a pad token is a real key whose LN is the LN
shift. The one-launch kernel pads with zeros before its LN; the three
launches (and their plain versions, :func:`tinyvit_window_block_plain`) run
LN + qkv on the unpadded tokens and read a pad token's qkv, ``LN(0) @ Wqkv +
b = ln_bias @ Wqkv + b``, from one row (:func:`pad_qkv_row`) wherever a
window reaches outside the grid. Pad queries are never written.

Dispatch is by the tensor's device: a CPU tensor takes the plain route, a
CUDA tensor launches the kernels or raises. ``tinyvit_window_block.launches``
and ``tinyvit_attention.launches`` count launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import check, kernels
from .autograd import refuse_grad
from .constants import made_once
from .fused_ln import _check_bf16, _derived, _f32, _on_cpu, _ptr, gemm_bf16, gemm_plain

HEAD_DIM = 32  # every TinyViT-5M stage
KERNEL_WINDOWS = (7, 14)


@functools.lru_cache(maxsize=8)
def offset_index(ws: int) -> np.ndarray:
    """(T, T) index of each token pair's offset in the (2ws-1)^2 bias table
    (the JAX package's ``tinyvit._offset_index``)."""
    coords = np.stack(np.mgrid[:ws, :ws], -1).reshape(-1, 2)
    rel = coords[:, None, :] - coords[None, :, :] + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


@made_once(maxsize=8)
def _offset_index_on(ws: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(offset_index(ws)).to(device)


def pad_qkv_row(ln_bias, wqkv, bqkv, dtype):
    """The qkv of a zero pad token, ``LN(0) @ Wqkv + b``, in ``dtype``.

    LN(0) is the LayerNorm's bias (a zero row has zero mean and variance), in
    the activation dtype as the TPU kernel holds it. Weights only, so it is
    made once per weight set (kept on ``wqkv``)."""
    def make(w):
        ln0 = ln_bias.detach().to(dtype).float()
        return (ln0 @ w.float() + bqkv.detach().float()).to(dtype).contiguous()

    return _derived(wqkv, ("pad_qkv", dtype), make, deps=(ln_bias, bqkv))


def _windows(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, PH, PW, D) -> (B * nh * nw, ws * ws, D), windows in row-major order."""
    b, ph, pw, d = t.shape
    nh, nw = ph // ws, pw // ws
    t = t.reshape(b, nh, ws, nw, ws, d).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b * nh * nw, ws * ws, d)


def _unwindows(t: torch.Tensor, b: int, ph: int, pw: int, ws: int) -> torch.Tensor:
    nh, nw = ph // ws, pw // ws
    t = t.reshape(b, nh, nw, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, ph, pw, -1)


def _attend(q, k, v, bias_table, ws: int):
    """Per-window multi-head attention in fp32 with the learned bias.
    q, k, v (N, heads, T, hd) fp32; bias_table (heads, (2ws-1)^2)."""
    hd = q.shape[-1]
    idx = _offset_index_on(ws, q.device)
    bias = bias_table.float()[:, idx]  # (heads, T, T)
    logits = (q * hd ** -0.5) @ k.transpose(-1, -2) + bias
    return torch.softmax(logits, dim=-1) @ v


def tinyvit_attention_plain(qkv, pad_row, bias_table, heads: int, ws: int):
    """fp32 version of :func:`tinyvit_attention` (output in qkv's dtype):
    the grid is padded to window multiples with ``pad_row``, then each window
    attends over its ws^2 tokens."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    ph, pw = -(-h // ws) * ws, -(-w // ws) * ws
    grid = pad_row.float().reshape(1, 1, 1, c3).repeat(b, ph, pw, 1)
    grid[:, :h, :w] = qkv.float()
    win = _windows(grid, ws).reshape(-1, ws * ws, 3, heads, hd).permute(2, 0, 3, 1, 4)
    o = _attend(win[0], win[1], win[2], bias_table, ws)  # (N, heads, T, hd)
    o = _unwindows(o.permute(0, 2, 1, 3).reshape(-1, ws * ws, c), b, ph, pw, ws)
    return o[:, :h, :w].to(qkv.dtype).contiguous()


def tinyvit_attention(qkv, pad_row, bias_table, heads: int, ws: int):
    """(B, H, W, 3C) qkv of the unpadded grid, the (3C,) pad-token row and the
    raw (heads, (2ws-1)^2) bias table -> (B, H, W, C) window attention.

    The kernel takes bf16 qkv, pad row and table, head dim 32, ws 7 or 14."""
    b, h, w, c3 = qkv.shape
    c = c3 // 3
    if c3 != 3 * c or c % heads or tuple(pad_row.shape) != (c3,):
        raise ValueError(f"tinyvit_attention: bad geometry {tuple(qkv.shape)}, heads={heads}, "
                         f"pad row {tuple(pad_row.shape)}")
    if tuple(bias_table.shape) != (heads, (2 * ws - 1) ** 2):
        raise ValueError(f"tinyvit_attention: bias table {tuple(bias_table.shape)}, need "
                         f"{(heads, (2 * ws - 1) ** 2)}")
    if _on_cpu(qkv):
        return tinyvit_attention_plain(qkv, pad_row, bias_table, heads, ws)
    refuse_grad("tinyvit_attention", qkv, pad_row, bias_table)
    if c // heads != HEAD_DIM or ws not in KERNEL_WINDOWS:
        raise ValueError(f"tinyvit_attention kernel takes head dim {HEAD_DIM} and ws 7 or 14; "
                         f"got hd={c // heads}, ws={ws}")
    dev = qkv.device
    _check_bf16("qkv", qkv, (b, h, w, c3), dev)
    _check_bf16("pad_row", pad_row, (c3,), dev)
    _check_bf16("bias_table", bias_table, tuple(bias_table.shape), dev)
    out = torch.empty((b, h, w, c), dtype=torch.bfloat16, device=dev)
    err = kernels().ysi_tinyvit_attn(_ptr(qkv), _ptr(pad_row), _ptr(bias_table), _ptr(out),
                                     b, h, w, heads, ws, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "tinyvit_attention")
    tinyvit_attention.launches += 1
    return out


tinyvit_attention.launches = 0


# csrc/tinyvit_block.cu's layout: a head's qkv slab is 96 rows of 128-byte K
# chunks (12 KB), a projection box 64 rows (8 KB); a weight slot holds either;
# the H100's opt-in shared memory of a block.
_QKV_BOX, _PRJ_BOX = 3 * HEAD_DIM * 128, 64 * 128
BLOCK_SMEM_BUDGET = 227 * 1024


def _window(ws: int) -> dict:
    t = ws * ws
    ns, kpv = -(-t // 8) * 8, -(-t // 16) * 16
    return {"t": t, "mt": -(-t // 64), "ns": ns, "kpv": kpv, "nb": (2 * ws - 1) ** 2,
            "qk": ns * 128, "vt": -(-kpv // 64) * HEAD_DIM * 128}


# The widths csrc/tinyvit_block.cu is built for: (ws, C) of TinyViT-5M's
# stages 1 and 2. Stage 3 (C 320 at ws 7) keeps the three launches of
# _three_launches, faster there in turns with the one-launch kernel.
KERNEL_WIDTHS = ((7, 128), (14, 160))


def block_plan(c: int, heads: int, ws: int) -> tuple:
    """How ``csrc/tinyvit_block.cu`` lays out a block of width C (its
    ``Plan``): (consumer warpgroups a block, windows in flight a
    block, weights resident, weight slots, shared-memory bytes). Each window
    in flight has its QK tile (keys rounded up to 8, 128-byte rows k | q),
    V^T tile (64-key chunks of 32 rows), LN and O tiles (ws^2 x (C + 8)
    bf16 each), rounded up to 1024 bytes; the block holds the bias table
    (fp32) and the weights. At ws 7 (C 128), 2 warpgroups each on its own
    window, all the weights resident; at ws 14 (C 160), 2 warpgroups on one
    window, the weights in rounds of a slab's K chunks (one slot each).
    Raises ValueError for widths the kernel does not take."""
    if heads * HEAD_DIM != c or (ws, c) not in KERNEL_WIDTHS:
        raise ValueError(f"tinyvit block kernel takes head dim {HEAD_DIM}, ws 7 or 14 and "
                         f"(ws, C) in {KERNEL_WIDTHS}; got C {c}, {heads} heads, ws {ws}")
    win, kch = _window(ws), -(-c // 64)
    own = -(-(win["qk"] + win["vt"] + 2 * 2 * win["t"] * (c + 8)) // 1024) * 1024
    table = -(-heads * win["nb"] * 4 // 16) * 16
    if ws == 14:
        return 2, 1, False, kch, 1024 + kch * _QKV_BOX + own + table + 2 * kch * 8
    weights = heads * kch * _QKV_BOX + kch * kch * _PRJ_BOX
    return 2, 2, True, 0, 1024 + weights + 2 * own + table + 8


def block_schedule(b: int, h: int, w: int, ws: int, per_item: int, sms: int) -> tuple:
    """``csrc/tinyvit_block.cu``'s window schedule: (windows, items, blocks,
    the windows of each of a block's windows in flight). Window i is (image
    i // (ny nx), window row i // nx % ny, window column i % nx); item k holds
    windows k per_item .. k per_item + per_item - 1 (the windows in flight of
    :func:`block_plan`: at ws 7 one a warpgroup, the last item's second
    warpgroup possibly without one); block j of the persistent grid (one block
    an SM at most) takes items j, j + n, j + 2 n, ... with n the grid's
    blocks."""
    nx, ny = -(-w // ws), -(-h // ws)
    windows = b * nx * ny
    items = -(-windows // per_item)
    blocks = min(items, sms)
    walks = [[k * per_item + j for k in range(blk, items, blocks) if k * per_item + j < windows]
             for blk in range(blocks) for j in range(per_item)]
    return windows, items, blocks, walks


def real_query_tiles(ws: int, rows: int, cols: int) -> list:
    """The 64-query tiles of a window that the kernel computes: those holding
    a query inside the grid, for a window whose first ``rows`` rows and
    ``cols`` columns are (the kernel's ``real_tile``). The others' queries are
    pad tokens, whose output is never stored; their tokens stay keys."""
    t = ws * ws
    tiles = []
    for mt in range(-(-t // 64)):
        i0, i1 = mt * 64, min(mt * 64 + 64, t) - 1
        r0, r1 = i0 // ws, i1 // ws
        if r0 < rows and (i0 % ws < cols or (r0 + 1 <= r1 and r0 + 1 < rows)):
            tiles.append(mt)
    return tiles


def qkv_slabs(wqkv: torch.Tensor) -> torch.Tensor:
    """(C, 3C) qkv weights in JAX's (in, out) layout, q | k | v head-major ->
    the kernel's (3C, C) K-major slabs: for each head h the rows of its q, k
    and v output channels (96), each row the C inputs."""
    c = wqkv.shape[0]
    idx = torch.arange(3 * c).reshape(3, c // HEAD_DIM, HEAD_DIM).permute(1, 0, 2).reshape(-1)
    return wqkv.t()[idx.to(wqkv.device)].contiguous()


def _three_launches(x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads, ws,
                    eps, gemm, attention):
    """LN + qkv on the unpadded tokens, the window attention (pad tokens as
    keys, from :func:`pad_qkv_row`), the projection with the residual."""
    b, h, w, c = x.shape
    x2 = x.reshape(-1, c).contiguous()
    qkv = gemm(x2, wqkv, bqkv, ln=(ln_scale, ln_bias, eps))
    pad = pad_qkv_row(ln_bias, wqkv, bqkv, x.dtype)
    o = attention(qkv.reshape(b, h, w, 3 * c), pad, bias_table, heads, ws)
    return gemm(o.reshape(-1, c), wproj, bproj, r1=x2).reshape(x.shape)


def tinyvit_window_block(x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                         heads: int, ws: int, eps: float = 1e-5):
    """x (B, H, W, C) pre-norm -> ``x + proj(window_attn(LN(pad(x))))`` (K13).

    A CPU tensor takes :func:`tinyvit_window_block_plain`. A CUDA tensor
    (bf16 x and weights, head dim 32) at :data:`KERNEL_WIDTHS` takes one
    launch of ``csrc/tinyvit_block.cu``; at other widths (TinyViT-5M's stage
    3) three: ``gemm_bf16`` (LN + qkv), :func:`tinyvit_attention`,
    ``gemm_bf16`` (projection + residual)."""
    b, h, w, c = x.shape
    if tuple(bias_table.shape) != (heads, (2 * ws - 1) ** 2):
        raise ValueError(f"tinyvit_window_block: bias table {tuple(bias_table.shape)}, need "
                         f"{(heads, (2 * ws - 1) ** 2)}")
    if tuple(wqkv.shape) != (c, 3 * c) or tuple(wproj.shape) != (c, c):
        raise ValueError(f"tinyvit_window_block: weights {tuple(wqkv.shape)}, "
                         f"{tuple(wproj.shape)} for C {c}")
    args = (x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads, ws, eps)
    if _on_cpu(x):
        return tinyvit_window_block_plain(*args)
    refuse_grad("tinyvit_window_block", *args[:8])
    if heads * HEAD_DIM != c or ws not in KERNEL_WINDOWS:  # before any launch, on either route
        raise ValueError(f"tinyvit_window_block kernels take head dim {HEAD_DIM} and ws 7 or 14; "
                         f"got C {c}, {heads} heads, ws {ws}")
    if (ws, c) not in KERNEL_WIDTHS:
        return _three_launches(*args, gemm_bf16, tinyvit_attention)
    dev = x.device
    _check_bf16("x", x, (b, h, w, c), dev)
    _check_bf16("wqkv", wqkv, (c, 3 * c), dev)
    _check_bf16("wproj", wproj, (c, c), dev)
    slabs = _derived(wqkv, "tinyvit_qkv_slabs", qkv_slabs)
    wproj_t = _derived(wproj, "t", lambda v: v.t().contiguous())
    out = torch.empty_like(x)
    err = kernels().ysi_tinyvit_block(
        _ptr(x), _ptr(slabs), _ptr(wproj_t), _ptr(_f32(bias_table)), _ptr(_f32(ln_scale)),
        _ptr(_f32(ln_bias)), _ptr(_f32(bqkv)), _ptr(_f32(bproj)), _ptr(out), b, h, w, c, ws,
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "tinyvit_window_block")
    tinyvit_window_block.launches += 1
    return out


tinyvit_window_block.launches = 0


def tinyvit_window_block_plain(x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                               heads: int, ws: int, eps: float = 1e-5):
    """The three launches' plain versions on any device, in fp32 (result in
    x's dtype): LN + qkv on the unpadded tokens, the window attention with pad
    tokens as keys (from :func:`pad_qkv_row`), the projection with the
    residual."""
    return _three_launches(x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj, heads,
                           ws, eps, gemm_plain, tinyvit_attention_plain)


def tinyvit_window_block_reference(x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                                   heads: int, ws: int, eps: float = 1e-5):
    """The block as the official TinyViT writes it, in fp32: zero-pad x,
    window partition, LN, qkv, attention, projection, unpad, residual. It
    shares no step with the kernel route."""
    b, h, w, c = x.shape
    hd = c // heads
    ph, pw = -(-h // ws) * ws, -(-w // ws) * ws
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, pw - w, 0, ph - h))
    win = torch.nn.functional.layer_norm(_windows(xp, ws), (c,), ln_scale.float(),
                                         ln_bias.float(), eps)
    qkv = (win @ wqkv.float() + bqkv.float()).reshape(-1, ws * ws, 3, heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    o = _attend(qkv[0], qkv[1], qkv[2], bias_table, ws).permute(0, 2, 1, 3)
    o = o.reshape(-1, ws * ws, c) @ wproj.float() + bproj.float()
    o = _unwindows(o, b, ph, pw, ws)[:, :h, :w]
    return (x.float() + o).to(x.dtype)


__all__ = [
    "KERNEL_WIDTHS", "block_plan", "block_schedule", "offset_index", "pad_qkv_row", "qkv_slabs",
    "real_query_tiles", "tinyvit_attention", "tinyvit_attention_plain", "tinyvit_window_block",
    "tinyvit_window_block_plain", "tinyvit_window_block_reference",
]
