"""Per-prompt window crop of the decoder's token grid (kernel K8).

Counterpart of ``yolo_sam_inference_tpu/ops/window_crop.py``: each prompt's
(wg, wg, C) window of its (gs, gs, C) keys grid, which the engine's mask head
upscales instead of the whole grid. On the card ``csrc/window_crop.cu``
copies the windows, reading the starts where they lie; its source note says
what bounds it.

Dispatch is by the tensor's device: CPU takes the plain version, CUDA
launches the kernel or raises. ``window_crop.launches`` counts launches.
"""

from __future__ import annotations

import torch

from ._build import check, kernels
from .autograd import refuse_grad
from .fused_ln import _check_bf16, _on_cpu


def window_crop_plain(grid, r0, c0, wg: int):
    """(N, gs, gs, C) + per-prompt starts (N,) -> (N, wg, wg, C); the starts
    are clamped to [0, gs - wg]."""
    n, gs = grid.shape[0], grid.shape[1]
    dev = grid.device
    ar = torch.arange(wg, device=dev)
    rows = r0.long().clamp(0, gs - wg)[:, None] + ar
    cols = c0.long().clamp(0, gs - wg)[:, None] + ar
    idx = torch.arange(n, device=dev)
    return grid[idx[:, None, None], rows[:, :, None], cols[:, None, :]]


def window_crop(grid, r0, c0, wg: int):
    """See :func:`window_crop_plain`. CUDA tensors launch ``window_crop_kernel``
    (bf16, C a multiple of 8), which reads the starts in place: (N,) int64
    tensors on the grid's card, of any stride (the engine passes the two
    columns of its (N, 2) starts)."""
    n, gs, gs2, c = grid.shape
    if gs != gs2 or not 0 < wg <= gs:
        raise ValueError(f"window_crop: grid {tuple(grid.shape)}, window {wg}")
    if _on_cpu(grid):
        return window_crop_plain(grid, r0, c0, wg)
    refuse_grad("window_crop", grid)
    if c % 8:
        raise ValueError(f"window_crop kernel takes C a multiple of 8, got {c}")
    _check_bf16("grid", grid, (n, gs, gs, c), grid.device)
    for name, t in (("r0", r0), ("c0", c0)):
        if t.shape != (n,) or t.device != grid.device or t.dtype != torch.int64:
            raise ValueError(f"window_crop kernel: {name} must be ({n},) int64 on "
                             f"{grid.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    out = torch.empty((n, wg, wg, c), dtype=grid.dtype, device=grid.device)
    err = kernels().ysi_window_crop(grid.data_ptr(), r0.data_ptr(), c0.data_ptr(), r0.stride(0),
                                    c0.stride(0), out.data_ptr(), n, gs, c, wg,
                                    torch.cuda.current_stream(grid.device).cuda_stream)
    check(err, "window_crop")
    window_crop.launches += 1
    return out


window_crop.launches = 0

__all__ = ["window_crop", "window_crop_plain"]
