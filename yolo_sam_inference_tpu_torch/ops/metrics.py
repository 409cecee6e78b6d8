"""Batched cell morphometrics: all 16 reference metrics per cell mask.

Counterpart of ``yolo_sam_inference_tpu/ops/metrics.py``: area, centroid
and bbox by masked reductions; the skimage-exact 4-neighbourhood perimeter
(:func:`perimeter_4n`); the convex hull from the boundary edge midpoints and
per-direction support points, measured as the exact polygon (shoelace,
``hull_mode="polygon"``) or rasterised and re-measured as the reference
does (``hull_mode="reference"``); brightness mean/std in the centroid disk.
:func:`calculate_metrics` is the single-cell host API.

Masks are fixed-size crops ``(N, h, w)`` with per-cell ``(row0, col0)``
offsets into the frame. The hull's candidates and support points are
kernel K9 (:func:`..ops.hull_support.hull_support`).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .constants import constant, made_once
from .hull_support import hull_support

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


@made_once(maxsize=8)
def _hull_directions_on(num_directions: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_hull_directions(num_directions)).to(device)


def _hull_vertices(masks: torch.Tensor, num_directions: int):
    """(N, h, w) -> (support vertices (N, D, 2) in angular order, non-empty (N,)).
    K9 from the masks: the kernel on a CUDA tensor, its plain version (the
    candidates, then the selection) on the CPU."""
    on = masks if masks.dtype == torch.bool else masks > 0
    return hull_support(on.contiguous(), _hull_directions_on(num_directions, masks.device))


def convex_hull_measures(masks: torch.Tensor, num_directions: int = 256):
    """(area, perimeter) of the convex hull of each (N, h, w) mask; 0 when empty."""
    verts, any_mask = _hull_vertices(masks, num_directions)
    nxt = torch.roll(verts, shifts=-1, dims=1)
    cross = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    hull_area = 0.5 * cross.sum(dim=1).abs()
    seg = torch.sqrt(((nxt - verts) ** 2).sum(dim=-1) + 1e-12)
    seg = torch.where((nxt == verts).all(dim=-1), torch.zeros_like(seg), seg)
    hull_perim = seg.sum(dim=1)
    zero = torch.zeros_like(hull_area)
    return torch.where(any_mask, hull_area, zero), torch.where(any_mask, hull_perim, zero)


def rasterized_hull_measures(masks: torch.Tensor, num_directions: int = 256):
    """The reference's hull measures (``hull_mode="reference"``): the hull
    polygon rasterised onto the crop's pixel centres and re-measured, area as
    the pixel count and perimeter by :func:`perimeter_4n` (the public
    ``polygon2mask`` + ``regionprops``). Its weighted perimeter runs about 3%
    longer than the exact polygon's, so deformability reads about +0.03.

    The hull is the intersection of its D edge half-planes; for each row of
    pixel centres every half-plane bounds the column interval, so the raster
    is built from per-(cell, row) [cmin, cmax] intervals: (N, h, D) work."""
    m = masks.float()
    _, h, w = m.shape
    dev = m.device
    verts, any_mask = _hull_vertices(masks, num_directions)  # (N, D, 2) CCW

    # In angular vertex order the interior lies left of each edge
    # e = v_{i+1} - v_i:  e_c * r - e_r * c <= e_c * v_r - e_r * v_c.
    nxt = torch.roll(verts, shifts=-1, dims=1)
    e = nxt - verts  # zero rows for repeated vertices
    n_r = e[..., 1]  # coefficient of r in the <= constraint
    n_c = -e[..., 0]  # coefficient of c
    b = e[..., 1] * verts[..., 0] - e[..., 0] * verts[..., 1]  # (N, D)

    r_grid = torch.arange(h, dtype=torch.float32, device=dev)  # pixel-centre rows
    resid = b[:, None, :] - r_grid[None, :, None] * n_r[:, None, :]  # (N, h, D)

    eps = 1e-4
    pos = n_c > eps  # bounds c from above: c <= resid / n_c
    neg = n_c < -eps  # bounds c from below
    axial = ~(pos | neg)  # n_c ~ 0: the row's feasibility (or a repeated vertex)
    safe_nc = torch.where(axial, torch.ones_like(n_c), n_c)
    bound = resid / safe_nc[:, None, :]
    big = constant(_BIG, torch.float32, dev)
    cmax = torch.where(pos[:, None, :], bound, big).amin(dim=-1)  # (N, h)
    cmin = torch.where(neg[:, None, :], bound, -big).amax(dim=-1)
    row_ok = torch.where(axial[:, None, :], resid, big).amin(dim=-1) >= -eps

    c_grid = torch.arange(w, dtype=torch.float32, device=dev)
    # polygon2mask's even-odd rule counts crossings strictly right of the
    # pixel centre: a centre exactly ON the left crossing is inside, one ON
    # the right crossing outside, hence the asymmetric eps (hull edges of
    # slope p/q do pass through pixel centres)
    raster = ((c_grid >= cmin[..., None] - eps) & (c_grid <= cmax[..., None] - eps)
              & row_ok[..., None] & any_mask[:, None, None])
    rf = raster.float()
    return rf.sum(dim=(1, 2)), perimeter_4n(rf)


HULL_MODES = ("polygon", "reference")


def _area_centroid(on: torch.Tensor, off: torch.Tensor):
    """Area (N,) fp32 and centroid rows and columns (N,) fp32 in frame
    coordinates of (N, h, w) bool masks with (N, 2) fp32 offsets. The pixel
    count and the moments are summed exactly in int64 (each row's count times
    its index), divided in fp64, rounded to fp32, then offset in fp32. On
    crops every fp32 sum is exact too, and an fp64 quotient rounded to fp32
    is the correctly rounded fp32 quotient, so crops get the bits of the fp32
    formula; on whole frames fp32 sums round and move the centroid, and with
    it the brightness disk (F13 in ``ROADMAP.md``)."""
    _, h, w = on.shape
    per_row = on.sum(dim=2, dtype=torch.int64)  # (N, h)
    per_col = on.sum(dim=1, dtype=torch.int64)  # (N, w)
    area = per_row.sum(dim=1)
    mr = (per_row * torch.arange(h, device=on.device)).sum(dim=1)
    mc = (per_col * torch.arange(w, device=on.device)).sum(dim=1)
    safe = area.clamp(min=1).double()
    return area.float(), (mr / safe).float() + off[:, 0], (mc / safe).float() + off[:, 1]


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
    hull_mode: str = "polygon",
) -> Dict[str, torch.Tensor]:
    """All 16 metrics for N cells drawn from a batch of frames.

    masks (N, h, w) crops; gray (B, H, W) fp32 frames; img_idx (N,) frame of
    each cell; offsets (N, 2) crop origin (row0, col0). Returns (N,) arrays.
    ``hull_mode``: "polygon" measures the exact hull polygon;
    "reference" the reference's rasterise-and-remeasure procedure
    (:func:`rasterized_hull_measures`), for numbers that line up with the
    reference's CSVs.
    """
    if hull_mode not in HULL_MODES:
        raise ValueError(f"unknown hull_mode: {hull_mode!r} (one of {HULL_MODES})")
    m = masks.float()
    _, h, w = m.shape
    dev = m.device
    off = offsets.float()
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    on = m > 0
    big = constant(_BIG, torch.float32, dev)

    area, cr, cc = _area_centroid(on, off)
    nonempty = area > 0
    safe_area = area.clamp(min=1.0)

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
    hull = rasterized_hull_measures if hull_mode == "reference" else convex_hull_measures
    hull_area, hull_perim = hull(on, num_directions)
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
    hull_mode: str = "polygon",
) -> Dict[str, torch.Tensor]:
    """All 16 metrics for K cells of one image: masks (K, h, w), gray (H, W)."""
    k = masks.shape[0]
    if offsets is None:
        offsets = torch.zeros((k, 2), dtype=torch.int64, device=masks.device)
    if image_shape is None:
        image_shape = tuple(gray_image.shape)
    img_idx = torch.zeros((k,), dtype=torch.int64, device=masks.device)
    return cell_metrics(masks, gray_image[None].float(), img_idx, offsets, image_shape,
                        num_directions, hull_mode)


def calculate_metrics(image: np.ndarray, mask: np.ndarray, hull_mode: str = "polygon",
                      device: Union[str, torch.device] = "cuda") -> Dict[str, Any]:
    """Single-cell host API (the reference's ``calculate_metrics(image,
    mask)``): image (H, W, 3), mask (H, W) (extra singleton dims squeezed),
    measured on ``device``. Returns the 16 keys as Python scalars: ints for
    the area, hull area, lengths and bbox (``convex_hull_area`` rounded, as
    the reference's schema has it), floats elsewhere."""
    mask = np.asarray(mask)
    if mask.ndim > 2:
        mask = mask.squeeze()
    mask = mask.astype(bool)
    image = np.asarray(image)
    if mask.shape != image.shape[:2]:
        raise ValueError(f"Mask shape {mask.shape} does not match image shape "
                         f"{image.shape[:2]}")
    gray = image.mean(axis=2).astype(np.float32)
    with torch.inference_mode():
        out = batched_cell_metrics(torch.from_numpy(mask[None]).to(device),
                                   torch.from_numpy(gray).to(device), hull_mode=hull_mode)
        out = {key: float(v[0]) for key, v in out.items()}
    return {key: int(round(out[key])) if key in INT_METRIC_KEYS else out[key]
            for key in METRIC_KEYS}


def calculate_metrics_no_convex_hull(image: np.ndarray, mask: np.ndarray,
                                     device: Union[str, torch.device] = "cuda"
                                     ) -> Dict[str, Any]:
    """The classical pipeline's variant with placeholder hull values:
    circularity = deformability = 0.5, area_ratio = 1.0, the hull's area and
    perimeter those of the mask."""
    full = calculate_metrics(image, mask, device=device)
    full.update({
        "circularity": 0.5,
        "deformability": 0.5,
        "area_ratio": 1.0,
        "convex_hull_area": full["area"],
        "convex_hull_perimeter": full["perimeter"],
    })
    return full
