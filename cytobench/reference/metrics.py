"""The 16 morphometrics of a cell mask, in plain PyTorch.

Each cell is a crop mask (N, h, w) at a (row, col) offset in its frame.
Area, bounding box and lengths are counts; the perimeter is skimage's
4-neighbourhood perimeter; the convex hull is the polygon through the
support points, in 256 equally spaced directions, of the mask's boundary
edge midpoints (each row's outer columns -/+ 0.5, each column's outer rows
-/+ 0.5), picked by float32 scores, ties going to the larger row, then the
larger column; the brightness is the mean and standard deviation of the gray frame in the disk
of radius int(0.1 min(H, W)) around the centroid, clipped to the frame.

``work`` is the type of the floating-point work: float64 for the reference,
a lower precision for the control of ``cytobench/control.py``. The centroid
is rounded to float32, as the metric states it, before the disk is drawn.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

KEYS = ("deformability", "area", "area_ratio", "circularity", "convex_hull_area",
        "mask_x_length", "mask_y_length", "min_x", "min_y", "max_x", "max_y",
        "mean_brightness", "brightness_std", "perimeter", "aspect_ratio",
        "convex_hull_perimeter")
# counts and pixel coordinates: compared exactly
EXACT_KEYS = ("area", "mask_x_length", "mask_y_length", "min_x", "min_y", "max_x", "max_y")
DIRECTIONS = 256


def perimeter(m: torch.Tensor, work) -> torch.Tensor:
    """skimage ``perimeter(neighborhood=4)`` of (N, h, w) bool masks: the
    border pixels (not 4-eroded, outside counting as empty) coded by their
    border neighbours, each code weighted."""
    mf = F.pad(m.float()[:, None], (1, 1, 1, 1))
    cross = torch.tensor([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=torch.float32, device=m.device)
    hits = F.conv2d(mf, cross[None, None])[:, 0]
    border = (m & (hits < 5)).float()
    code_k = torch.tensor([[10, 2, 10], [2, 1, 2], [10, 2, 10]], dtype=torch.float32,
                          device=m.device)
    code = F.conv2d(F.pad(border[:, None], (1, 1, 1, 1)), code_k[None, None])[:, 0].long()
    weights = torch.zeros(50, dtype=torch.float64, device=m.device)
    weights[[5, 7, 15, 17, 25, 27]] = 1.0
    weights[[21, 33]] = math.sqrt(2.0)
    weights[[13, 23]] = (1.0 + math.sqrt(2.0)) / 2.0
    return (weights.to(work)[code.clamp(max=49)] * border.to(work)).sum((1, 2))


def hull(m: torch.Tensor, work) -> Tuple[torch.Tensor, torch.Tensor]:
    """(area, perimeter) of the support polygon of each (N, h, w) mask; 0 if
    empty. The metric picks its vertices by float32 scores, each two rounded
    products and a rounded sum of float32 directions, so ties fall the same
    way wherever it is computed; the polygon is measured in ``work``."""
    n, h, w = m.shape
    dev = m.device
    sdt = work if torch.finfo(work).bits < 32 else torch.float32
    rows = torch.arange(h, device=dev, dtype=sdt)
    cols = torch.arange(w, device=dev, dtype=sdt)
    big = 1e9
    row_ok, col_ok = m.any(2), m.any(1)
    minc = torch.where(m, cols, big).amin(2)
    maxc = torch.where(m, cols, -big).amax(2)
    minr = torch.where(m, rows[:, None], big).amin(1)
    maxr = torch.where(m, rows[:, None], -big).amax(1)
    pr = torch.cat([rows.expand(n, h), rows.expand(n, h), minr - 0.5, maxr + 0.5], 1)
    pc = torch.cat([minc - 0.5, maxc + 0.5, cols.expand(n, w), cols.expand(n, w)], 1)
    ok = torch.cat([row_ok, row_ok, col_ok, col_ok], 1)
    ang = torch.arange(DIRECTIONS, device=dev, dtype=torch.float64) * (2 * math.pi / DIRECTIONS)
    dr, dc = torch.cos(ang).to(sdt), torch.sin(ang).to(sdt)
    score = pr[..., None] * dr + pc[..., None] * dc  # (N, P, D)
    score = torch.where(ok[..., None], score, -big)
    best = score >= score.amax(1, keepdim=True)
    vr = torch.where(best, pr[..., None], -big).amax(1)  # (N, D)
    vc = torch.where(best & (pr[..., None] >= vr[:, None]), pc[..., None], -big).amax(1)
    vr, vc = vr.to(work), vc.to(work)
    nr, nc = vr.roll(-1, 1), vc.roll(-1, 1)
    area = 0.5 * (vr * nc - nr * vc).sum(1).abs()
    perim = torch.sqrt((nr - vr) ** 2 + (nc - vc) ** 2).sum(1)
    nonempty = m.flatten(1).any(1)
    return torch.where(nonempty, area, 0.0), torch.where(nonempty, perim, 0.0)


def brightness(gray: torch.Tensor, img: torch.Tensor, cr: torch.Tensor, cc: torch.Tensor,
               radius: int, work, block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std of gray[img] over frame pixels within
    ``radius`` of (cr, cc), float32 centres; blocks of cells at a time."""
    _, h, w = gray.shape
    side = 2 * radius + 3
    means, stds = [], []
    for s in range(0, cr.numel(), block):
        r0 = torch.floor(cr[s:s + block]).long() - radius - 1
        c0 = torch.floor(cc[s:s + block]).long() - radius - 1
        ar = torch.arange(side, device=gray.device)
        rr, cl = r0[:, None] + ar, c0[:, None] + ar
        inside = ((rr[:, :, None] >= 0) & (rr[:, :, None] < h) & (cl[:, None, :] >= 0)
                  & (cl[:, None, :] < w))
        d2 = ((rr.float() - cr[s:s + block, None]) ** 2)[:, :, None] + \
            ((cl.float() - cc[s:s + block, None]) ** 2)[:, None, :]
        sel = inside & (d2 <= float(radius) ** 2)
        vals = gray[img[s:s + block, None, None], rr.clamp(0, h - 1)[:, :, None],
                    cl.clamp(0, w - 1)[:, None, :]].to(work)
        cnt = sel.sum((1, 2)).clamp(min=1).to(work)
        mean = torch.where(sel, vals, 0.0).sum((1, 2)) / cnt
        var = (torch.where(sel, vals - mean[:, None, None], 0.0) ** 2).sum((1, 2)) / cnt
        means.append(mean)
        stds.append(torch.sqrt(var))
    return torch.cat(means), torch.cat(stds)


def cell_metrics(masks: torch.Tensor, offsets: torch.Tensor, gray: torch.Tensor,
                 img: torch.Tensor, work=torch.float64) -> Dict[str, torch.Tensor]:
    """masks (N, h, w) bool, offsets (N, 2) int, gray (B, H, W) frames, img
    (N,) each cell's frame -> {key: (N,)} in ``work`` (counts exact)."""
    n, h, w = masks.shape
    m = masks.bool()
    dev = m.device
    off = offsets.to(dev).long()
    per_row = m.sum(2)
    per_col = m.sum(1)
    area = per_row.sum(1)
    nonempty = area > 0
    safe = area.clamp(min=1)
    ri = torch.arange(h, device=dev)
    ci = torch.arange(w, device=dev)
    cr = ((per_row * ri).sum(1).double() / safe.double()).float() + off[:, 0].float()
    cc = ((per_col * ci).sum(1).double() / safe.double()).float() + off[:, 1].float()
    big = 1 << 30
    min_r = torch.where(m, ri[:, None], big).amin((1, 2)) + off[:, 0]
    max_r = torch.where(m, ri[:, None], -big).amax((1, 2)) + 1 + off[:, 0]
    min_c = torch.where(m, ci, big).amin((1, 2)) + off[:, 1]
    max_c = torch.where(m, ci, -big).amax((1, 2)) + 1 + off[:, 1]
    zero = torch.zeros_like(area)
    min_r, max_r, min_c, max_c = (torch.where(nonempty, t, zero) for t in (min_r, max_r, min_c,
                                                                           max_c))
    x_len, y_len = max_r - min_r, max_c - min_c
    areaw = area.to(work)
    hull_area, hull_perim = hull(m, work)
    radius = int(0.1 * min(gray.shape[1], gray.shape[2]))
    mean_b, std_b = brightness(gray, img.to(dev), cr, cc, radius, work)
    circ = torch.where(hull_perim > 0, 2.0 * torch.sqrt(math.pi * hull_area)
                       / hull_perim.clamp(min=1e-6), 0.0)
    fz = torch.zeros_like(areaw)
    return {
        "deformability": torch.where(nonempty, 1.0 - circ, torch.ones_like(areaw)),
        "area": area,
        "area_ratio": torch.where(nonempty, hull_area / areaw.clamp(min=1), fz),
        "circularity": circ,
        "convex_hull_area": hull_area,
        "mask_x_length": x_len,
        "mask_y_length": y_len,
        "min_x": min_r,
        "min_y": min_c,
        "max_x": max_r,
        "max_y": max_c,
        "mean_brightness": torch.where(nonempty, mean_b, fz),
        "brightness_std": torch.where(nonempty, std_b, fz),
        "perimeter": perimeter(m, work),
        "aspect_ratio": torch.where((x_len > 0) & (y_len > 0),
                                    x_len.to(work) / y_len.clamp(min=1).to(work), fz),
        "convex_hull_perimeter": hull_perim,
    }
