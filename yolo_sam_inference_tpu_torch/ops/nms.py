"""Batched fixed-shape greedy NMS (counterpart of ``ops/nms.py``).

Takes the top ``num_candidates`` boxes per image, runs the exact sequential
greedy suppression (vectorised over the batch, one step per candidate) and
returns ``max_det`` padded boxes with a validity mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.spans import span


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., K, 4) xyxy boxes -> (..., K, K)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_det: int = 64,
    iou_threshold: float = 0.7,
    conf_threshold: float = 0.25,
    num_candidates: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """boxes (B, N, 4), scores (B, N) -> (B, max_det, 4), (B, max_det), valid (B, max_det).
    One span, ``nms``, covers the call (``utils/spans.py``)."""
    with span("nms"):
        k = min(num_candidates, scores.shape[1])
        top_scores, idx = torch.topk(scores, k, dim=1, sorted=True)
        top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        suppress = _iou_matrix(top_boxes) > iou_threshold  # (B, K, K)
        conf_ok = top_scores >= conf_threshold

        # greedy in score order: keep i iff no earlier kept box overlaps it
        kept = torch.zeros_like(conf_ok)
        for i in range(k):
            blocked = (kept[:, :i] & suppress[:, i, :i]).any(dim=1)
            kept[:, i] = conf_ok[:, i] & ~blocked

        # kept first, score order preserved; pad to max_det
        order = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
        kept_sorted = torch.gather(kept, 1, order)[:, :max_det]
        boxes_sorted = torch.gather(top_boxes, 1, order[..., None].expand(-1, -1, 4))[:, :max_det]
        scores_sorted = torch.gather(top_scores, 1, order)[:, :max_det]
        out_scores = torch.where(kept_sorted, scores_sorted, torch.zeros_like(scores_sorted))
        out_boxes = torch.where(kept_sorted[..., None], boxes_sorted,
                                torch.zeros_like(boxes_sorted))
        return out_boxes, out_scores, kept_sorted
