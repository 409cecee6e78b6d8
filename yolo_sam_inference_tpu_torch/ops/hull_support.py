"""Convex-hull support points of cell masks (kernel K9).

Counterpart of ``yolo_sam_inference_tpu/ops/hull_support.py``: for each cell
and each of D directions, the boundary candidate with the largest projection,
ties broken by the largest row, then the largest column. On the card
``csrc/hull_support.cu`` computes the scores and the selection in one pass;
its source note says what bounds it.

Dispatch is by the tensor's device: CPU takes the plain version, CUDA
launches the kernel or raises. ``support_points.launches`` counts launches.
"""

from __future__ import annotations

import torch

from ._build import check, kernels
from .autograd import refuse_grad
from .fused_ln import _on_cpu


def select_support_points(pts: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Per-direction support point from the scores; among score-tied
    candidates the max r, then the max c. pts (N, P, 2), scores (N, P, D)
    -> (N, D, 2)."""
    mx = scores.amax(dim=1, keepdim=True)
    elig = scores >= mx
    r = pts[..., 0][:, :, None]
    c = pts[..., 1][:, :, None]
    neg = torch.tensor(-1e9, device=pts.device)
    vr = torch.where(elig, r, neg).amax(dim=1)  # (N, D)
    elig2 = elig & (r >= vr[:, None, :])
    vc = torch.where(elig2, c, neg).amax(dim=1)
    return torch.stack([vr, vc], dim=-1)


def support_points_plain(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """pts (N, P, 2) fp32 (r, c), dirs (D, 2) fp32 -> support points (N, D, 2).
    Each score is two products and a sum, each rounded (the kernel's order)."""
    scores = pts[..., 0:1] * dirs[:, 0] + pts[..., 1:2] * dirs[:, 1]  # (N, P, D)
    return select_support_points(pts, scores)


def support_points(pts: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """See :func:`support_points_plain`. CUDA tensors launch
    ``hull_support_kernel`` (fp32, at most 4096 candidates per cell)."""
    if _on_cpu(pts):
        return support_points_plain(pts, dirs)
    refuse_grad("support_points", pts, dirs)
    n, p, two = pts.shape
    d = dirs.shape[0]
    if two != 2 or tuple(dirs.shape) != (d, 2) or p > 4096:
        raise ValueError(f"support_points: pts {tuple(pts.shape)}, dirs {tuple(dirs.shape)}")
    for name, t in (("pts", pts), ("dirs", dirs)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != pts.device:
            raise ValueError(f"support_points kernel: {name} must be contiguous fp32 on "
                             f"{pts.device}, got {t.dtype} on {t.device}")
    out = torch.empty((n, d, 2), dtype=torch.float32, device=pts.device)
    err = kernels().ysi_hull_support(pts.data_ptr(), dirs.data_ptr(), out.data_ptr(), n, p, d,
                                     torch.cuda.current_stream(pts.device).cuda_stream)
    check(err, "support_points")
    support_points.launches += 1
    return out


support_points.launches = 0

__all__ = ["select_support_points", "support_points", "support_points_plain"]
