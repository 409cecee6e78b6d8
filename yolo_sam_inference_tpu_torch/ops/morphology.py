"""Batched image morphology and filtering for the classical pipeline.

Counterpart of ``yolo_sam_inference_tpu/ops/morphology.py`` (XLA there, no
``pallas_call``; plain PyTorch here): absdiff -> blur -> threshold ->
dilate / erode / open / close over a whole frame batch on the card, in place
of per-frame cv2 calls on the host. Every op takes (..., H, W) tensors and
runs where its input lies: on the card for a CUDA tensor, on the CPU for a
CPU one.

Border semantics are cv2's defaults: dilation pads with -inf and erosion
with +inf (cv2's BORDER_CONSTANT with its morphology border value), so a
border pixel never erodes for want of neighbours; the blur reflects about
the edge pixel (BORDER_REFLECT_101).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _as_planes(x: torch.Tensor) -> tuple:
    """(..., H, W) -> ((N, 1, H, W) fp32, the leading shape)."""
    lead = tuple(x.shape[:-2])
    return x.float().reshape(-1, 1, *x.shape[-2:]), lead


def dilate(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    """Binary dilation with a k x k rectangle; outside the frame counts as
    background (-inf padding). Returns bool (..., H, W)."""
    m, lead = _as_planes(mask)
    for _ in range(iterations):
        m = F.max_pool2d(m, k, 1, k // 2)
    return (m > 0.5).reshape(*lead, *m.shape[-2:])


def erode(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    """Binary erosion with a k x k rectangle; outside the frame counts as
    foreground (+inf padding, cv2's default), so the frame's edge does not
    erode a mask that touches it. Returns bool (..., H, W)."""
    m, lead = _as_planes(mask)
    for _ in range(iterations):
        m = -F.max_pool2d(-m, k, 1, k // 2)
    return (m > 0.5).reshape(*lead, *m.shape[-2:])


def morph_open(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    return dilate(erode(mask, k, iterations), k, iterations)


def morph_close(mask: torch.Tensor, k: int = 3, iterations: int = 1) -> torch.Tensor:
    return erode(dilate(mask, k, iterations), k, iterations)


@functools.lru_cache(maxsize=16)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel's taps (sigma <= 0 derived from ksize), fp32."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur_last_axis(x: torch.Tensor, taps) -> torch.Tensor:
    """The windowed sum along the last axis of (N, L) fp32 rows, reflect
    padded: tap by tap, a product then a sum each, in tap order (the JAX
    module's order, so a pixel at the threshold rounds the same way)."""
    n = x.shape[-1]
    pad = len(taps) // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    out = xp[:, 0:n] * taps[0]
    for i in range(1, len(taps)):
        out = out + xp[:, i:i + n] * taps[i]
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 5, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) images in fp32, cv2's taps and
    BORDER_REFLECT_101: the last axis first, then the second-to-last."""
    taps = torch.from_numpy(_gaussian_kernel_1d(ksize, float(sigma))).to(img.device)
    taps = [taps[i] for i in range(ksize)]
    x = img.float()
    shape = x.shape
    h, w = shape[-2], shape[-1]
    x = _blur_last_axis(x.reshape(-1, w), taps).reshape(shape)
    xt = x.transpose(-1, -2).reshape(-1, h)
    x = _blur_last_axis(xt, taps).reshape(*shape[:-2], w, h).transpose(-1, -2)
    return x.contiguous()


def subtract_clip(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2.subtract: saturating subtraction, clipped at 0."""
    return torch.clamp_min(a.float() - b.float(), 0.0)


def absdiff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs()


def threshold_binary(img: torch.Tensor, thresh: float) -> torch.Tensor:
    """cv2.THRESH_BINARY: strictly above ``thresh`` -> True."""
    return img > thresh


def contrast(img: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """cv2.convertScaleAbs-style linear contrast, clipped to [0, 255]."""
    return torch.clamp(img.float() * alpha + beta, 0.0, 255.0)


def classical_detect_batch(
    frames: torch.Tensor,
    background: torch.Tensor,
    threshold: float = 10.0,
    blur_kernel: int = 5,
    blur_sigma: float = 0.0,
    dilate_iterations: int = 2,
    erode_iterations: int = 2,
) -> torch.Tensor:
    """The background-subtraction preprocessing, batched: frames (B, H, W)
    gray (uint8 or float), background (H, W) -> (B, H, W) bool masks.
    absdiff -> Gaussian blur -> binary threshold -> dilate -> erode -> open."""
    diff = absdiff(frames, background[None])
    blurred = gaussian_blur(diff, blur_kernel, blur_sigma)
    binary = threshold_binary(blurred, threshold)
    m = dilate(binary, 3, dilate_iterations)
    m = erode(m, 3, erode_iterations)
    return morph_open(m, 3, 1)


__all__ = ["absdiff", "classical_detect_batch", "contrast", "dilate", "erode",
           "gaussian_blur", "morph_close", "morph_open", "subtract_clip",
           "threshold_binary"]
