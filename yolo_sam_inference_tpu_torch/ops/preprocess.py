"""Batched preprocessing: letterbox for YOLO, resize + pad + normalise for SAM.

Counterpart of ``yolo_sam_inference_tpu/ops/preprocess.py``. Images are
channels-last ``(B, H, W, C)`` tensors on the pipeline's device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .constants import constant, made_once

# SAM (ImageNet) normalization constants, matching SamProcessor defaults.
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=32)
def _linear_weights(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) resampling matrix of ``jax.image.resize(method=
    "linear")``: half-pixel centres and a triangle kernel whose support
    widens by the downsampling factor (antialiasing), rows normalised."""
    scale = in_len / out_len
    kernel_scale = max(scale, 1.0)
    centers = (np.arange(out_len, dtype=np.float64) + 0.5) * scale - 0.5
    j = np.arange(in_len, dtype=np.float64)
    w = np.clip(1.0 - np.abs(j[None, :] - centers[:, None]) / kernel_scale, 0.0, None)
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@made_once(maxsize=32)
def _linear_weights_on(in_len: int, out_len: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """:func:`_linear_weights` on ``device`` in ``dtype``, made once."""
    return torch.from_numpy(_linear_weights(in_len, out_len)).to(device, dtype)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, antialiased on downsample), NHWC float."""
    h, w = img.shape[-3], img.shape[-2]
    if h == out_h and w == out_w:
        return img
    wy = _linear_weights_on(h, out_h, img.device, torch.float32)
    wx = _linear_weights_on(w, out_w, img.device, torch.float32)
    return torch.einsum("oh,...hwc,pw->...opc", wy, img, wx)


def letterbox_batch(
    images: torch.Tensor, size: int, pad_value: float = 114.0
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """(B, H, W, 3) -> ((B, size, size, 3) fp32 in [0, 1], scale, (pad_x, pad_y)):
    aspect-preserving fit with centred gray padding (ultralytics convention)."""
    b, h, w, c = images.shape
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    resized = resize_bilinear(images.float(), nh, nw)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    out = torch.full((b, size, size, c), pad_value, dtype=torch.float32, device=images.device)
    out[:, pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return out / 255.0, r, (pad_x, pad_y)


def sam_preprocess_batch(
    images: torch.Tensor, size: int = 1024
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Resize the longest side to ``size``, ImageNet-normalise, zero-pad
    bottom/right (SamProcessor semantics). Returns (batch, scale, (nh, nw))."""
    b, h, w, c = images.shape
    r = size / max(h, w)
    nh, nw = int(h * r + 0.5), int(w * r + 0.5)
    resized = resize_bilinear(images.float(), nh, nw)
    mean = constant(SAM_MEAN, torch.float32, images.device)
    std = constant(SAM_STD, torch.float32, images.device)
    out = torch.zeros((b, size, size, c), dtype=torch.float32, device=images.device)
    out[:, :nh, :nw] = (resized - mean) / std
    return out, r, (nh, nw)


def scale_boxes_from_letterbox(
    boxes: torch.Tensor, scale: float, pad: Tuple[int, int]
) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coords back to original image coords."""
    px, py = pad
    shift = torch.tensor([px, py, px, py], dtype=boxes.dtype, device=boxes.device)
    return (boxes - shift) / scale


def boxes_to_sam_coords(boxes: torch.Tensor, sam_scale: float) -> torch.Tensor:
    """Map xyxy boxes in original-image coords to SAM encoder-input coords."""
    return boxes * sam_scale


def upsample_masks_bilinear(masks: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the last two axes, (..., h, w) -> (..., out_h, out_w),
    as ``jax.image.resize(method="bilinear")``: half-pixel centres,
    antialiased where it shrinks; non-float masks are resized as fp32."""
    h, w = masks.shape[-2], masks.shape[-1]
    if h == out_h and w == out_w:
        return masks
    x = masks if masks.is_floating_point() else masks.float()
    wy = _linear_weights_on(h, out_h, x.device, x.dtype)
    wx = _linear_weights_on(w, out_w, x.device, x.dtype)
    return torch.einsum("oh,...hw,pw->...op", wy, x, wx)
