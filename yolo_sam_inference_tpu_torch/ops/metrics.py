"""Batched cell morphometrics: all 16 reference metrics per cell mask.

Counterpart of ``yolo_sam_inference_tpu/ops/metrics.py`` (``hull_mode=
"polygon"``): area, centroid and bbox by masked reductions; the skimage-exact
4-neighbourhood perimeter (:func:`perimeter_4n`); the convex hull from the
boundary edge midpoints, per-direction support points and the shoelace
formula; brightness mean/std in the centroid disk.

Masks are fixed-size crops ``(N, h, w)`` with per-cell ``(row0, col0)``
offsets into the frame. The hull's support-point selection is kernel K9
(:func:`..ops.hull_support.support_points`).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .hull_support import support_points

METRIC_KEYS = (
    "deformability",
    "area",
    "area_ratio",
    "circularity",
    "convex_hull_area",
    "mask_x_length",
    "mask_y_length",
    "min_x",
    "min_y",
    "max_x",
    "max_y",
    "mean_brightness",
    "brightness_std",
    "perimeter",
    "aspect_ratio",
    "convex_hull_perimeter",
)

# metrics the CSV rows report as integers
INT_METRIC_KEYS = (
    "area",
    "convex_hull_area",
    "mask_x_length",
    "mask_y_length",
    "min_x",
    "min_y",
    "max_x",
    "max_y",
)

_BIG = 1.0e9


def perimeter_4n(mask: torch.Tensor) -> torch.Tensor:
    """``skimage.measure.perimeter(mask, neighborhood=4)`` of (..., h, w) masks."""
    m = mask.float()
    h, w = m.shape[-2], m.shape[-1]
    mp = F.pad(m, (1, 1, 1, 1))

    def sl(t, dr, dc):
        return t[..., 1 + dr:1 + dr + h, 1 + dc:1 + dc + w]

    eroded = m * sl(mp, -1, 0) * sl(mp, 1, 0) * sl(mp, 0, -1) * sl(mp, 0, 1)
    border = m - eroded
    bp = F.pad(border, (1, 1, 1, 1))
    diag = sl(bp, -1, -1) + sl(bp, -1, 1) + sl(bp, 1, -1) + sl(bp, 1, 1)
    orth = sl(bp, -1, 0) + sl(bp, 1, 0) + sl(bp, 0, -1) + sl(bp, 0, 1)
    code = 10.0 * diag + 2.0 * orth + border

    def any_of(*vals):
        out = torch.zeros_like(code, dtype=torch.bool)
        for v in vals:
            out |= code == v
        return out.float()

    sqrt2 = math.sqrt(2.0)
    per_pixel = (
        any_of(5.0, 7.0, 15.0, 17.0, 25.0, 27.0)
        + any_of(21.0, 33.0) * sqrt2
        + any_of(13.0, 23.0) * ((1.0 + sqrt2) / 2.0)
    ) * border
    return per_pixel.sum(dim=(-2, -1))


@functools.lru_cache(maxsize=8)
def _hull_directions(num_directions: int) -> np.ndarray:
    ang = np.arange(num_directions, dtype=np.float64) * (2.0 * np.pi / num_directions)
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)  # (D, 2)


def _hull_candidates(masks: torch.Tensor):
    """Boundary edge-midpoint candidates (N, 2h+2w, 2) as (r, c), and whether
    each mask is non-empty."""
    m = masks.float()
    k, h, w = m.shape
    dev = m.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    on = m > 0
    any_mask = on.flatten(1).any(dim=1)
    area = m.sum(dim=(1, 2))
    cr = (m * rows).sum(dim=(1, 2)) / area.clamp(min=1.0)
    cc = (m * cols).sum(dim=(1, 2)) / area.clamp(min=1.0)

    big = torch.tensor(_BIG, device=dev)
    minc = torch.where(on, cols, big).amin(dim=2)  # (N, h)
    maxc = torch.where(on, cols, -big).amax(dim=2)
    row_ok = on.any(dim=2)
    minr = torch.where(on, rows, big).amin(dim=1)  # (N, w)
    maxr = torch.where(on, rows, -big).amax(dim=1)
    col_ok = on.any(dim=1)
    r_idx = torch.arange(h, dtype=torch.float32, device=dev)[None].expand(k, h)
    c_idx = torch.arange(w, dtype=torch.float32, device=dev)[None].expand(k, w)

    # invalid rows/cols collapse to the centroid (inside the hull, never extreme)
    def fill(pr, pc, ok):
        pr = torch.where(ok, pr, cr[:, None].expand_as(pr))
        pc = torch.where(ok, pc, cc[:, None].expand_as(pc))
        return torch.stack([pr, pc], dim=-1)

    pts = torch.cat(
        [
            fill(r_idx, minc - 0.5, row_ok),
            fill(r_idx, maxc + 0.5, row_ok),
            fill(minr - 0.5, c_idx, col_ok),
            fill(maxr + 0.5, c_idx, col_ok),
        ],
        dim=1,
    )
    return pts.contiguous(), any_mask


def convex_hull_measures(masks: torch.Tensor, num_directions: int = 256):
    """(area, perimeter) of the convex hull of each (N, h, w) mask; 0 when empty."""
    pts, any_mask = _hull_candidates(masks)
    dirs = torch.from_numpy(_hull_directions(num_directions)).to(pts.device)
    verts = support_points(pts, dirs)
    nxt = torch.roll(verts, shifts=-1, dims=1)
    cross = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    hull_area = 0.5 * cross.sum(dim=1).abs()
    seg = torch.sqrt(((nxt - verts) ** 2).sum(dim=-1) + 1e-12)
    seg = torch.where((nxt == verts).all(dim=-1), torch.zeros_like(seg), seg)
    hull_perim = seg.sum(dim=1)
    zero = torch.zeros_like(hull_area)
    return torch.where(any_mask, hull_area, zero), torch.where(any_mask, hull_perim, zero)


def _brightness_disk(gray, img_idx, cr, cc, radius: int):
    """Mean/std of ``gray[img_idx]`` inside the integer-radius disk around
    each float centroid, clipped at the image border (not masked by the cell).
    gray (B, H, W); img_idx, cr, cc (N,)."""
    _, h, w = gray.shape
    win = 2 * radius + 3
    pad = radius + 1
    gpad = F.pad(gray, (pad, pad, pad, pad))
    r0 = (torch.floor(cr).long() - radius - 1).clamp(-pad, h + pad - win)
    c0 = (torch.floor(cc).long() - radius - 1).clamp(-pad, w + pad - win)
    ar = torch.arange(win, device=gray.device)
    rr = r0[:, None] + ar[None]  # (N, win) frame rows
    cc_idx = c0[:, None] + ar[None]
    window = gpad[img_idx[:, None, None], (rr + pad)[:, :, None], (cc_idx + pad)[:, None, :]]
    wr = rr.float()[:, :, None]
    wc = cc_idx.float()[:, None, :]
    in_disk = (wr - cr[:, None, None]) ** 2 + (wc - cc[:, None, None]) ** 2 <= float(radius) ** 2
    in_img = (wr >= 0) & (wr < h) & (wc >= 0) & (wc < w)
    sel = (in_disk & in_img).float()
    n = sel.sum(dim=(1, 2)).clamp(min=1.0)
    mean = (window * sel).sum(dim=(1, 2)) / n
    var = (((window - mean[:, None, None]) * sel) ** 2).sum(dim=(1, 2)) / n
    return mean, torch.sqrt(var)


def cell_metrics(
    masks: torch.Tensor,
    gray: torch.Tensor,
    img_idx: torch.Tensor,
    offsets: torch.Tensor,
    image_shape: Tuple[int, int],
    num_directions: int = 256,
) -> Dict[str, torch.Tensor]:
    """All 16 metrics for N cells drawn from a batch of frames.

    masks (N, h, w) crops; gray (B, H, W) fp32 frames; img_idx (N,) frame of
    each cell; offsets (N, 2) crop origin (row0, col0). Returns (N,) arrays.
    """
    m = masks.float()
    _, h, w = m.shape
    dev = m.device
    off = offsets.float()
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    on = m > 0
    big = torch.tensor(_BIG, device=dev)

    area = m.sum(dim=(1, 2))
    nonempty = area > 0
    safe_area = area.clamp(min=1.0)
    cr = (m * rows).sum(dim=(1, 2)) / safe_area + off[:, 0]
    cc = (m * cols).sum(dim=(1, 2)) / safe_area + off[:, 1]

    zero = torch.zeros_like(area)
    # bbox in regionprops convention: (min_row, min_col, max_row + 1, max_col + 1)
    min_r = torch.where(nonempty, torch.where(on, rows, big).amin(dim=(1, 2)) + off[:, 0], zero)
    max_r = torch.where(nonempty, torch.where(on, rows, -big).amax(dim=(1, 2)) + 1.0 + off[:, 0], zero)
    min_c = torch.where(nonempty, torch.where(on, cols, big).amin(dim=(1, 2)) + off[:, 1], zero)
    max_c = torch.where(nonempty, torch.where(on, cols, -big).amax(dim=(1, 2)) + 1.0 + off[:, 1], zero)
    x_len = max_r - min_r  # rows ("x" in the reference's row/col naming)
    y_len = max_c - min_c
    aspect = torch.where((x_len > 0) & (y_len > 0), x_len / y_len.clamp(min=1.0), zero)

    perim = perimeter_4n(m)
    hull_area, hull_perim = convex_hull_measures(m, num_directions)
    area_ratio = torch.where(nonempty, hull_area / safe_area, zero)
    circularity = torch.where(
        hull_perim > 0,
        2.0 * torch.sqrt(math.pi * hull_area) / hull_perim.clamp(min=1e-6),
        zero,
    )
    radius = int(0.1 * min(image_shape))
    mean_b, std_b = _brightness_disk(gray, img_idx, cr, cc, radius)
    return {
        # empty mask: circularity 0, deformability 1 (the reference's hull-failure path)
        "deformability": torch.where(nonempty, 1.0 - circularity, torch.ones_like(area)),
        "area": area,
        "area_ratio": area_ratio,
        "circularity": circularity,
        "convex_hull_area": hull_area,
        "mask_x_length": torch.where(nonempty, x_len, zero),
        "mask_y_length": torch.where(nonempty, y_len, zero),
        "min_x": min_r,
        "min_y": min_c,
        "max_x": max_r,
        "max_y": max_c,
        "mean_brightness": torch.where(nonempty, mean_b, zero),
        "brightness_std": torch.where(nonempty, std_b, zero),
        "perimeter": perim,
        "aspect_ratio": aspect,
        "convex_hull_perimeter": hull_perim,
    }


def batched_cell_metrics(
    masks: torch.Tensor,
    gray_image: torch.Tensor,
    offsets: Optional[torch.Tensor] = None,
    image_shape: Optional[Tuple[int, int]] = None,
    num_directions: int = 256,
) -> Dict[str, torch.Tensor]:
    """All 16 metrics for K cells of one image: masks (K, h, w), gray (H, W)."""
    k = masks.shape[0]
    if offsets is None:
        offsets = torch.zeros((k, 2), dtype=torch.int64, device=masks.device)
    if image_shape is None:
        image_shape = tuple(gray_image.shape)
    img_idx = torch.zeros((k,), dtype=torch.int64, device=masks.device)
    return cell_metrics(masks, gray_image[None].float(), img_idx, offsets, image_shape,
                        num_directions)
