"""The reference's stages over a batch of frames, in the blocks that let a
whole batch run beside nothing else on one card.

:func:`candidates` is detection up to the NMS (every anchor's box and
score), :func:`detect` adds the NMS, :func:`embed` is SAM's encoder,
:func:`crops` the prompts, decoder, mask head and crop resampling for given
boxes, :func:`pipeline` all of them and the metrics: the outputs of one
batch in the program's layout, from the reference alone. :func:`embed` and
:func:`crops` are the configuration's model family's
(``cytobench/families/``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..flops import yolo_size
from ..manifest import family
from . import metrics as rmetrics
from . import preprocess, yolo

BUDGET = 1 << 29  # bytes of the largest intermediate a block holds


def _block(per_item: int) -> int:
    return max(1, BUDGET // max(1, per_item))


def cast(tree, dtype):
    """The tree with every tensor in ``dtype``: the models run in the type
    of their weights (the judge's bfloat16 yardstick runs them in bf16)."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return None if tree is None else tree.to(dtype)


def candidates(ytree: Dict, frames: torch.Tensor, cfg: Dict, traffic: Dict,
               quant: Optional[str] = None) -> Dict:
    """Every anchor of every frame: boxes in letterbox pixels ``boxes_lb``
    and mapped to the frame and clamped into it ``boxes``, ``scores``, and
    each anchor's ``stride``; with the letterbox ``scale``."""
    size = yolo_size(traffic)
    b, h, w = frames.shape
    out = {"boxes_lb": [], "scores": []}
    step = _block(size ** 2 * 64 * 4)
    for s in range(0, b, step):
        lb, r, (px, py) = preprocess.letterbox(frames[s:s + step], size)
        boxes, scores, strides = yolo.decode(yolo.forward(ytree, lb, quant), cfg["yolo"]["reg_max"])
        out["boxes_lb"].append(boxes)
        out["scores"].append(scores)
    boxes_lb = torch.cat(out["boxes_lb"])
    shift = torch.tensor([px, py, px, py], device=frames.device, dtype=torch.float32)
    lim = torch.tensor([w - 1, h - 1, w - 1, h - 1], device=frames.device, dtype=torch.float32)
    return {"boxes_lb": boxes_lb, "scores": torch.cat(out["scores"]), "stride": strides,
            "scale": r, "boxes": torch.minimum(((boxes_lb - shift) / r).clamp(min=0.0), lim)}


def detect(cand: Dict, traffic: Dict) -> Dict:
    """Greedy NMS of every frame's anchors -> boxes (B, K, 4), scores, valid,
    the kept first, best first, zero-padded to K = max_det."""
    b = cand["scores"].shape[0]
    k = traffic["max_det"]
    dev = cand["scores"].device
    boxes = torch.zeros((b, k, 4), device=dev)
    scores = torch.zeros((b, k), device=dev)
    valid = torch.zeros((b, k), dtype=torch.bool, device=dev)
    for i in range(b):
        kept = yolo.nms(cand["boxes_lb"][i], cand["scores"][i], k, traffic["iou_threshold"],
                        traffic["conf_threshold"], traffic["nms_candidates"])
        n = kept.numel()
        boxes[i, :n] = cand["boxes"][i, kept]
        scores[i, :n] = cand["scores"][i, kept]
        valid[i, :n] = True
    return {"boxes": boxes, "scores": scores, "valid": valid}


def embed(stree: Dict, frames: torch.Tensor, cfg: Dict, traffic: Dict,
          quant: Optional[str] = None):
    """SAM's image embedding of the frames, in the form that the model
    family's :func:`crops` takes."""
    return family(cfg).embed(stree, frames, cfg, traffic, quant)


def offsets(boxes: torch.Tensor, crop: int, h: int, w: int) -> torch.Tensor:
    """(..., 4) frame boxes -> (..., 2) crop origins: the crop centred on the
    box centre (rounded half to even), kept inside the frame."""
    cy = torch.round((boxes[..., 1] + boxes[..., 3]) * 0.5).long()
    cx = torch.round((boxes[..., 0] + boxes[..., 2]) * 0.5).long()
    return torch.stack([(cy - crop // 2).clamp(0, h - crop), (cx - crop // 2).clamp(0, w - crop)],
                       -1)


def crops(stree: Dict, emb, boxes: torch.Tensor, valid: torch.Tensor, frame_hw, cfg: Dict,
          traffic: Dict, quant: Optional[str] = None) -> Dict:
    """For every box (B, K, 4): its crop origin (B, K, 2) and the fp32 mask
    logits of its crop (B, K, crop, crop), from the model family's
    :func:`embed`; invalid slots' logits are -inf (no mask)."""
    return family(cfg).crops(stree, emb, boxes, valid, frame_hw, cfg, traffic, quant)


def metrics(masks: torch.Tensor, offs: torch.Tensor, frames: torch.Tensor,
            work=torch.float64) -> Dict[str, torch.Tensor]:
    """The 16 metrics of every slot's mask (B, K, crop, crop) -> {key: (B, K)}."""
    b, k = masks.shape[:2]
    img = torch.arange(b, device=masks.device).repeat_interleave(k)
    out = rmetrics.cell_metrics(masks.reshape(b * k, *masks.shape[2:]), offs.reshape(b * k, 2),
                                frames.float(), img, work)
    return {key: t.reshape(b, k) for key, t in out.items()}


def pipeline(trees, frames: torch.Tensor, cfg: Dict, traffic: Dict, quant: Optional[str] = None,
             work=torch.float64) -> Dict:
    """One batch through the reference alone, in the program's output layout
    (torch tensors): boxes, scores, valid, mask_crops, offsets, metrics."""
    ytree, stree = trees
    det = detect(candidates(ytree, frames, cfg, traffic, quant), traffic)
    emb = embed(stree, frames, cfg, traffic, quant)
    c = crops(stree, emb, det["boxes"], det["valid"], frames.shape[1:], cfg, traffic, quant)
    masks = c["logits"] > 0
    return dict(det, mask_crops=masks, offsets=c["offsets"],
                metrics=metrics(masks, c["offsets"], frames, work))
