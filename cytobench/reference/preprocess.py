"""Frame preprocessing of the reference: YOLO's letterbox and SAM's resize,
normalisation and padding, both with a linear resampling whose triangle
kernel widens by the shrink factor (half-pixel centres, rows normalised)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)
LETTERBOX_PAD = 114.0


def resample_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) float64 weights of the antialiased linear resize."""
    scale = in_len / out_len
    support = max(scale, 1.0)
    centres = (np.arange(out_len) + 0.5) * scale - 0.5
    w = np.clip(1.0 - np.abs(np.arange(in_len)[None, :] - centres[:, None]) / support, 0.0, None)
    return w / w.sum(axis=1, keepdims=True)


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) float -> (B, out_h, out_w, C) float32."""
    b, h, w, c = img.shape
    if (h, w) == (out_h, out_w):
        return img.float()
    wy = torch.from_numpy(resample_matrix(h, out_h)).float().to(img.device)
    wx = torch.from_numpy(resample_matrix(w, out_w)).float().to(img.device)
    return torch.einsum("oh,bhwc,pw->bopc", wy, img.float(), wx)


def rgb(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) gray uint8 -> (B, H, W, 3) float32 with the gray in every channel."""
    return frames_u8.float()[..., None].expand(*frames_u8.shape, 3)


def letterbox(frames_u8: torch.Tensor, size: int) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """(B, H, W) -> ((B, size, size, 3) in [0, 1], scale, (pad_x, pad_y)):
    the frame fitted with its aspect kept, centred on gray padding."""
    b, h, w = frames_u8.shape
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    py, px = (size - nh) // 2, (size - nw) // 2
    out = torch.full((b, size, size, 3), LETTERBOX_PAD, device=frames_u8.device)
    out[:, py:py + nh, px:px + nw] = resize(rgb(frames_u8), nh, nw)
    return out / 255.0, r, (px, py)


def sam_pixels(frames_u8: torch.Tensor, canvas: int) -> torch.Tensor:
    """(B, H, W) -> (B, canvas, canvas, 3): the longest side resized to the
    canvas, ImageNet-normalised, zero-padded at the bottom and right."""
    b, h, w = frames_u8.shape
    r = canvas / max(h, w)
    nh, nw = int(h * r + 0.5), int(w * r + 0.5)
    mean = torch.tensor(SAM_MEAN, device=frames_u8.device)
    std = torch.tensor(SAM_STD, device=frames_u8.device)
    out = torch.zeros((b, canvas, canvas, 3), device=frames_u8.device)
    out[:, :nh, :nw] = (resize(rgb(frames_u8), nh, nw) - mean) / std
    return out
