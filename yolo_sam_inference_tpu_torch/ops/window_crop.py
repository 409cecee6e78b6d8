"""Per-prompt window crop of the decoder's token grid (kernel K8).

Counterpart of ``yolo_sam_inference_tpu/ops/window_crop.py``: each prompt's
(wg, wg, C) window of its (gs, gs, C) keys grid, which the engine's mask head
upscales instead of the whole grid. On the card ``csrc/window_crop.cu``
copies the windows, reading the starts where they lie; its source note says
what bounds it.

Dispatch is by the tensor's device: CPU takes the plain version, CUDA
launches the kernel or raises. ``window_crop.launches`` counts launches.

:func:`crop_windows` gives each prompt's crop of the frame and the window
that covers it, :func:`crop_sample` the window's logits on the crop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

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


def crop_sample(win_logits, offset_rc, win_low_start, crop: int, scale_to_low: float):
    """Sample (N, crop, crop) frame-resolution logits from per-cell low-res
    windows (N, lw, lw) whose low-res origin is ``win_low_start`` (N, 2), the
    crops' origins in frame pixels ``offset_rc`` (N, 2). Frame pixel (r, c)
    maps to low-res ((r + 0.5) * s - 0.5); separable hat-function weights,
    two small products per cell."""
    lw = win_logits.shape[-1]
    dev = win_logits.device
    idx = torch.arange(crop, dtype=torch.float32, device=dev)
    off = offset_rc.float()
    start = win_low_start.float()
    ly = (off[:, 0:1] + idx + 0.5) * scale_to_low - 0.5
    lx = (off[:, 1:2] + idx + 0.5) * scale_to_low - 0.5
    ly = (ly - start[:, 0:1]).clamp(0.0, lw - 1.0)
    lx = (lx - start[:, 1:2]).clamp(0.0, lw - 1.0)
    j = torch.arange(lw, dtype=torch.float32, device=dev)
    py = (1.0 - (ly[..., None] - j).abs()).clamp(min=0.0)  # (N, crop, lw)
    px = (1.0 - (lx[..., None] - j).abs()).clamp(min=0.0)
    return torch.einsum("niw,nwv,njv->nij", py, win_logits.float(), px)


class CropWindows(NamedTuple):
    """Each prompt's crop and the window of the token grid that covers it
    (:func:`crop_windows`); ``sample`` is :func:`crop_sample` on them."""

    offsets: torch.Tensor  # (B, K, 2) the crops' origins in frame pixels
    flat: torch.Tensor  # the same, (B*K, 2)
    starts: torch.Tensor  # (B*K, 2) the windows' starts on the token grid
    side: int  # the windows' side in tokens
    crop: int  # the crops' side in frame pixels
    scale_to_low: float  # frame pixels -> low-res logits (4 a token)

    def sample(self, win_logits, low_start):
        return crop_sample(win_logits, self.flat, low_start, self.crop, self.scale_to_low)


def crop_windows(boxes, image_hw: Tuple[int, int], crop: int, gs: int,
                 scale_to_low: float) -> CropWindows:
    """A (crop, crop) crop of the frame centred on each box (B, K, 4), kept
    inside the frame, and, as a prompt's mask is only needed inside its crop,
    the window of the (gs, gs) token grid that covers it."""
    h, w = image_hw
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    off_r = (torch.round(cy).long() - crop // 2).clamp(0, h - crop)
    off_c = (torch.round(cx).long() - crop // 2).clamp(0, w - crop)
    offsets = torch.stack([off_r, off_c], dim=-1)
    scale_to_grid = scale_to_low / 4.0
    wg = min(gs, int(math.ceil(crop * scale_to_grid)) + 3)
    flat = offsets.reshape(-1, 2)
    starts = ((flat.float() * scale_to_grid).long() - 1).clamp(0, gs - wg)
    return CropWindows(offsets, flat, starts, wg, crop, scale_to_low)


__all__ = ["CropWindows", "crop_sample", "crop_windows", "window_crop", "window_crop_plain"]
