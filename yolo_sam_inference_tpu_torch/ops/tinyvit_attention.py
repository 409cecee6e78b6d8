"""TinyViT window attention block (kernel K13).

Counterpart of ``tinyvit_window_block`` and ``tinyvit_window_block_cells`` in
``yolo_sam_inference_tpu/ops/tinyvit_attention.py``: one function,
``x + proj(attn(LN(pad(x))) + learned bias)`` over non-overlapping
``ws x ws`` windows (ws 7 or 14, head dim 32), whose two TPU forms differ only
in how the windows are laid out in VMEM.

On the card it runs as three launches:

1. ``gemm_bf16`` with its LayerNorm prologue: LN1 + the qkv projection on the
   unpadded ``(B*H*W, C)`` tokens;
2. ``tinyvit_attention`` (``csrc/tinyvit_attn.cu``): the window attention with
   the learned per-offset bias, read from the raw ``(heads, (2ws-1)^2)``
   table, and an fp32 softmax;
3. ``gemm_bf16``: the output projection with the residual in its epilogue.

Spatial padding. The official TinyViT pads the pre-norm input with zeros and
normalises after windowing, so a pad token is a real key whose qkv is
``LN(0) @ Wqkv + b = ln_bias @ Wqkv + b``. That row depends on the weights
only (:func:`pad_qkv_row`, made once per weight set); the kernel reads it
wherever a window reaches outside the grid. Pad queries are never written.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``tinyvit_attention.launches``
counts launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._build import check, kernels
from .fused_ln import _check_bf16, _derived, _on_cpu, _ptr, gemm_bf16

HEAD_DIM = 32  # every TinyViT-5M stage
KERNEL_WINDOWS = (7, 14)


@functools.lru_cache(maxsize=8)
def offset_index(ws: int) -> np.ndarray:
    """(T, T) index of each token pair's offset in the (2ws-1)^2 bias table
    (the JAX package's ``tinyvit._offset_index``)."""
    coords = np.stack(np.mgrid[:ws, :ws], -1).reshape(-1, 2)
    rel = coords[:, None, :] - coords[None, :, :] + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


def pad_qkv_row(ln_bias, wqkv, bqkv, dtype):
    """The qkv of a zero pad token, ``LN(0) @ Wqkv + b``, in ``dtype``.

    LN(0) is the LayerNorm's bias (a zero row has zero mean and variance), in
    the activation dtype as the TPU kernel holds it. Weights only, so it is
    made once per weight set (kept on ``wqkv``)."""
    def make(w):
        ln0 = ln_bias.detach().to(dtype).float()
        return (ln0 @ w.float() + bqkv.detach().float()).to(dtype).contiguous()

    return _derived(wqkv, ("pad_qkv", ln_bias.data_ptr(), bqkv.data_ptr(), dtype), make)


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
    idx = torch.from_numpy(offset_index(ws)).to(q.device)
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


def tinyvit_window_block(x, bias_table, ln_scale, ln_bias, wqkv, bqkv, wproj, bproj,
                         heads: int, ws: int, eps: float = 1e-5, gemm=gemm_bf16,
                         attention=tinyvit_attention):
    """x (B, H, W, C) pre-norm -> ``x + proj(window_attn(LN(pad(x))))`` (K13).

    LN + qkv on the unpadded tokens, the window attention (pad tokens as
    keys, from :func:`pad_qkv_row`), the projection with the residual.
    ``gemm=gemm_plain, attention=tinyvit_attention_plain`` is the plain
    version on any device (the fp32 oracle)."""
    b, h, w, c = x.shape
    x2 = x.reshape(-1, c).contiguous()
    qkv = gemm(x2, wqkv, bqkv, ln=(ln_scale, ln_bias, eps))
    pad = pad_qkv_row(ln_bias, wqkv, bqkv, x.dtype)
    o = attention(qkv.reshape(b, h, w, 3 * c), pad, bias_table, heads, ws)
    return gemm(o.reshape(-1, c), wproj, bproj, r1=x2).reshape(x.shape)


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
    "offset_index", "pad_qkv_row", "tinyvit_attention", "tinyvit_attention_plain",
    "tinyvit_window_block", "tinyvit_window_block_reference",
]
