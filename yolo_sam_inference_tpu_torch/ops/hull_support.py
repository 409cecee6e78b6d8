"""Convex-hull support points of cell masks (kernel K9).

Counterpart of ``yolo_sam_inference_tpu/ops/hull_support.py`` and of the
candidates' front end of ``yolo_sam_inference_tpu/ops/metrics.py``
(``_hull_candidate_scores``): each mask's boundary edge midpoints, and for
each of D directions the candidate with the largest projection, ties broken
by the largest row, then the largest column. On the card
``csrc/hull_support.cu`` goes from the bool masks to the support points:
crops (both sides up to 256) in one launch, larger masks (whole frames) in
three over a scratch that the wrapper allocates (:func:`frame_plan`); its
source note says what bounds it.

Dispatch is by the tensor's device: CPU takes the plain version
(:func:`hull_candidates`, then :func:`support_points_plain`), CUDA launches
the kernel or raises. ``hull_support.launches`` counts launches and
``hull_candidates.calls`` the plain front end's calls.
"""

from __future__ import annotations

import functools

import torch

from ._build import check, kernels
from .autograd import refuse_grad
from .constants import constant
from .fused_ln import _on_cpu

_BIG = 1.0e9
# csrc/hull_support.cu: masks with both sides up to TILE take the crops'
# kernel; larger ones the frames' kernels, whose selection takes GROUP
# directions and CHUNK rows and columns at a time
TILE, GROUP, CHUNK = 256, 32, 256


def hull_candidates(masks: torch.Tensor):
    """Boundary edge-midpoint candidates (N, 2h+2w, 2) as (r, c), and whether
    each mask is non-empty: each row's extreme columns -+ 0.5, each column's
    extreme rows -+ 0.5; empty rows and columns collapse to the centroid."""
    hull_candidates.calls += 1
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

    big = constant(_BIG, torch.float32, dev)
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


hull_candidates.calls = 0


def select_support_points(pts: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Per-direction support point from the scores; among score-tied
    candidates the max r, then the max c. pts (N, P, 2), scores (N, P, D)
    -> (N, D, 2)."""
    mx = scores.amax(dim=1, keepdim=True)
    elig = scores >= mx
    r = pts[..., 0][:, :, None]
    c = pts[..., 1][:, :, None]
    neg = constant(-_BIG, torch.float32, pts.device)
    vr = torch.where(elig, r, neg).amax(dim=1)  # (N, D)
    elig2 = elig & (r >= vr[:, None, :])
    vc = torch.where(elig2, c, neg).amax(dim=1)
    return torch.stack([vr, vc], dim=-1)


def support_points_plain(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """pts (N, P, 2) fp32 (r, c), dirs (D, 2) fp32 -> support points (N, D, 2).
    Each score is two products and a sum, each rounded (the kernel's order)."""
    scores = pts[..., 0:1] * dirs[:, 0] + pts[..., 1:2] * dirs[:, 1]  # (N, P, D)
    return select_support_points(pts, scores)


def hull_support_plain(masks: torch.Tensor, dirs: torch.Tensor):
    """masks (N, h, w), dirs (D, 2) fp32 -> (support points (N, D, 2),
    non-empty (N,))."""
    pts, any_mask = hull_candidates(masks)
    return support_points_plain(pts, dirs), any_mask


def frame_plan(n: int, h: int, w: int, d: int, sms: int):
    """The frames' selection grid, (n, ceil(d / GROUP), slices) blocks, as
    (slices, chunks a slice): the rows and columns in chunks of CHUNK, split
    into slices until the grid holds about two blocks an SM (one slice when
    the masks alone fill the card; never a slice without a chunk)."""
    chunks = -(-max(h, w) // CHUNK)
    groups = -(-d // GROUP)
    want = max(1, min(chunks, -(-2 * sms // (n * groups))))
    per = -(-chunks // want)
    return -(-chunks // per), per


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def hull_support(masks: torch.Tensor, dirs: torch.Tensor):
    """See :func:`hull_support_plain`. CUDA tensors launch the kernels: bool
    masks, contiguous, of any sides; unit directions (D, 2), D > 0, fp32,
    contiguous, on the masks' card."""
    if _on_cpu(masks):
        return hull_support_plain(masks, dirs)
    refuse_grad("hull_support", dirs)
    if masks.dim() != 3 or tuple(dirs.shape[1:]) != (2,) or dirs.dim() != 2:
        raise ValueError(f"hull_support: masks {tuple(masks.shape)}, dirs {tuple(dirs.shape)}")
    n, h, w = masks.shape
    d = dirs.shape[0]
    if masks.dtype != torch.bool or not masks.is_contiguous() or h == 0 or w == 0:
        raise ValueError(f"hull_support kernel: masks must be contiguous bool, got {masks.dtype} "
                         f"{tuple(masks.shape)} contiguous={masks.is_contiguous()}")
    if dirs.dtype != torch.float32 or not dirs.is_contiguous() or dirs.device != masks.device \
            or d == 0:
        raise ValueError(f"hull_support kernel: dirs must be (D > 0, 2) contiguous fp32 on "
                         f"{masks.device}, got {tuple(dirs.shape)} {dirs.dtype} on {dirs.device}")
    dev = masks.device
    out = torch.empty((n, d, 2), dtype=torch.float32, device=dev)
    any_mask = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out, any_mask
    ext = part_s = part_k = None
    per = 0
    if h > TILE or w > TILE:  # the frames' scratch: extremes, then the slices' partials
        slices, per = frame_plan(n, h, w, d, _sm_count(dev))
        ext = torch.empty((n, 2 * (h + w)), dtype=torch.int32, device=dev)
        part_s = torch.empty((n, slices, d), dtype=torch.float32, device=dev)
        part_k = torch.empty((n, slices, d), dtype=torch.int64, device=dev)
    err = kernels().ysi_hull_support(masks.data_ptr(), dirs.data_ptr(), out.data_ptr(),
                                     any_mask.data_ptr(), *(None if t is None else t.data_ptr()
                                                            for t in (ext, part_s, part_k)),
                                     n, h, w, d, per, torch.cuda.current_stream(dev).cuda_stream)
    check(err, "hull_support")
    hull_support.launches += 1
    return out, any_mask


hull_support.launches = 0

__all__ = ["frame_plan", "hull_candidates", "hull_support", "hull_support_plain",
           "select_support_points", "support_points_plain"]
