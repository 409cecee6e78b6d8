"""How ``correct`` is decided: the program's outputs of sampled batches of
the window, judged against the plain fp32 reference (``cytobench/reference``)
on the same frames and weights.

The pipeline makes discrete choices (which anchors NMS keeps, which pixels
are inside a mask), and bfloat16 rounding may tip a near tie either way. So
each stage is judged on the program's own upstream outputs, as a served
model's tokens are. And how far a bfloat16 computation may stray from fp32
depends on the weights a seed draws (how many logits lie near zero, how
sharp the attention is), so the model's numbers are ratios: the program's
departure from the fp32 reference over the departure of a yardstick, the
same reference code with every model (YOLO, the encoder, the decoder and
the mask head's upscaling) in bfloat16 on the same bf16 weights, its
geometry, box decode, position encodings and crop sampling in fp32, on the
same frames and the program's boxes. A sound bf16 program reads about 1.

* detect: each kept box is matched to the reference anchor whose box lies
  nearest. ``box_ratio``: the root mean square over the kept boxes of
  their distance from their anchors' fp32 boxes (in units of each anchor's
  stride) over the yardstick's on the same anchors (the largest distance, an
  extreme of a few anchors whose box bins lie near uniform, barely tells
  bf16 from fp8); ``score_ratio``: the largest score error over the
  yardstick's. NMS is followed step by step on the program's picks: at each
  step the reference's best candidate that is clearly free (above the
  confidence, overlapping no earlier pick by more than the IoU threshold
  less ``IOU_MARGIN``) may not score above the pick; the largest such gap
  (also a pick below the confidence, and a stop while a free candidate
  remains) over the yardstick's largest score error is ``nms_gap_ratio``;
  a pick that overlaps an earlier one by more than the threshold plus
  ``IOU_MARGIN`` is counted (``nms_overlap``). A frame whose picks stop
  short of max_det while a candidate clearly above the confidence (by
  ``DET_MARGIN``, some forty times bfloat16's score error) is clear of
  every pick is counted apart (``det_miss``): a detection left out, as a
  stage that answers nothing for some frames leaves them.
* segment: the crop origins follow exactly from the boxes
  (``offset_miss``); an invalid slot has no mask pixel, box or score
  (``slot_miss``); ``mask_flip_ratio`` is the count of the valid slots'
  pixels on which the program's mask disagrees with the fp32 logit's sign
  over the yardstick's count, ``mask_gap_ratio`` the largest |fp32 logit|
  at such a pixel over the yardstick's largest.
* metrics: the reference measures the program's masks in float64; the
  counts and pixel coordinates are exact (``metric_exact_miss``), the other
  metrics within ``metric_rel`` (relative, or absolute below 1).

A cell's limits are in ``cytobench/workloads/<cell>.json``; ``PERF.md``
gives the readings each limit was set from.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import fp32_exact
from .reference import metrics as rmetrics
from .reference import pipeline as rpipe
from .reference.yolo import iou

IOU_MARGIN = 0.05
DET_MARGIN = 0.02
NUMBERS = ("box_ratio", "score_ratio", "nms_gap_ratio", "nms_overlap", "det_miss",
           "offset_miss", "slot_miss", "mask_flip_ratio", "mask_gap_ratio", "metric_exact_miss", "metric_rel")


def _ratio(num: float, den: float) -> float:
    return 0.0 if num == 0 else (num / den if den > 0 else float("inf"))


class _Tally:
    """Running maxima and counts over the judged batches."""

    def __init__(self) -> None:
        self.v: Dict[str, float] = {}

    def max(self, key: str, x: float) -> None:
        self.v[key] = max(self.v.get(key, 0.0), float(x))

    def add(self, key: str, x: float) -> None:
        self.v[key] = self.v.get(key, 0.0) + float(x)

    def __getitem__(self, key: str) -> float:
        return self.v.get(key, 0.0)


def _detect(t: _Tally, out: Dict, c32: Dict, c16: Dict, traffic: Dict) -> None:
    """Matches, errors and the teacher-forced NMS over the frames of a batch."""
    conf, thr = traffic["conf_threshold"], traffic["iou_threshold"]
    s32 = c32["scores"].double().cpu().numpy()
    s16 = c16["scores"].double().cpu().numpy()
    boxes = c32["boxes"].double()
    per_bin = float(c32["scale"]) / c32["stride"].double()
    top = torch.argsort(c32["scores"], 1, descending=True)[:, :traffic["nms_candidates"]]
    top = top.cpu().numpy()
    for i in range(s32.shape[0]):
        valid = np.asarray(out["valid"][i], bool)
        picks = torch.as_tensor(np.asarray(out["boxes"][i])[valid], dtype=torch.float64,
                                device=boxes.device)
        m = picks.shape[0]
        anchor = np.zeros(0, int)
        if m:
            dist = ((boxes[i][None] - picks[:, None]).abs().amax(-1) * per_bin).cpu().numpy()
            anchor = dist.argmin(1)
            e16 = ((c16["boxes"][i, anchor].double() - boxes[i, anchor]).abs().amax(-1)
                   * per_bin[anchor]).cpu().numpy()
            t.add("box_sq", (dist[np.arange(m), anchor] ** 2).sum())
            t.add("box16_sq", (e16 ** 2).sum())
            t.max("box", dist[np.arange(m), anchor].max())
            t.max("box16", e16.max())
            t.max("score", np.abs(s32[i, anchor] - np.asarray(out["scores"][i])[valid]).max())
            t.max("score16", np.abs(s32[i, anchor] - s16[i, anchor]).max())
        t.max("score16", np.abs(s32[i, top[i]] - s16[i, top[i]]).max())
        cands = top[i]
        lb = c32["boxes_lb"][i]
        with_picks = iou(lb[cands], lb[anchor]).cpu().numpy() if m else np.zeros((len(cands), 0))
        pick_pick = iou(lb[anchor], lb[anchor]).cpu().numpy() if m else np.zeros((0, 0))
        free = s32[i, cands] >= conf
        for k in range(m + 1):
            clear = free & ~np.isin(cands, anchor[:k])
            if k:
                clear &= with_picks[:, :k].max(1) <= thr - IOU_MARGIN
            best = s32[i, cands][clear].max() if clear.any() else None
            if k < m:
                s = s32[i, anchor[k]]
                t.max("gap", max(conf - s, (best - s) if best is not None else 0.0))
                if k and pick_pick[k, :k].max() > thr + IOU_MARGIN:
                    t.add("nms_overlap", 1)
            elif m < traffic["max_det"]:
                t.add("stops", 1)
                if best is not None:
                    t.max("gap", best - conf)
                    t.add("det_miss", best >= conf + DET_MARGIN)


def _segment(t: _Tally, out: Dict, r32: Dict, r16: Dict, valid: np.ndarray) -> None:
    dev = r32["logits"].device
    v = torch.as_tensor(valid, device=dev)
    prog = torch.as_tensor(np.asarray(out["mask_crops"]), device=dev)
    want = r32["logits"][v] > 0
    mag = r32["logits"][v].abs()
    flips = prog[v] != want
    flips16 = (r16["logits"][v] > 0) != want
    t.add("flips", flips.sum())
    t.add("flips16", flips16.sum())
    t.add("pixels", flips.numel())
    if flips.any():
        t.max("mask_gap", mag[flips].max())
    if flips16.any():
        t.max("mask_gap16", mag[flips16].max())
    t.add("slot_miss", prog[~v].flatten(1).any(1).sum()
          + int((np.abs(np.asarray(out["boxes"]))[~valid] > 0).any(-1).sum())
          + int((np.asarray(out["scores"])[~valid] != 0).sum()))
    got_off = torch.as_tensor(np.asarray(out["offsets"]), device=dev).long()
    t.add("offset_miss", (got_off != r32["offsets"]).any(-1).sum())


def _metrics(t: _Tally, out: Dict, frames: torch.Tensor, worst: Dict) -> None:
    dev = frames.device
    masks = torch.as_tensor(np.asarray(out["mask_crops"]), device=dev)
    offs = torch.as_tensor(np.asarray(out["offsets"]), device=dev).long()
    ref = rpipe.metrics(masks, offs, frames, torch.float64)
    for key in rmetrics.KEYS:
        got = torch.as_tensor(np.asarray(out["metrics"][key]), device=dev, dtype=torch.float64)
        want = ref[key].double()
        if key in rmetrics.EXACT_KEYS:
            t.add("metric_exact_miss", (got != want).sum())
            continue
        rel = (got - want).abs() / want.abs().clamp(min=1.0)
        if float(rel.max()) > t["metric_rel"]:
            j = int(rel.argmax())
            t.max("metric_rel", rel.max())
            worst["metric_rel"] = (f"{key} at slot {np.unravel_index(j, rel.shape)}: "
                                   f"{float(got.flatten()[j])!r} against {float(want.flatten()[j])!r}"
                                   f", area {int(ref['area'].flatten()[j])}")


def numbers(cfg: Dict, traffic: Dict, trees, batches: Sequence[Tuple[np.ndarray, Dict]],
            device) -> Tuple[Dict[str, float], Dict[str, str]]:
    """(every compared number, a few lines on where the largest came from)
    over the judged batches: (uint8 frames (B, H, W), the program's outputs
    as ``_fetch_outputs`` gives them)."""
    fp32_exact()
    ytree, stree = trees
    y16, s16 = rpipe.cast(ytree, torch.bfloat16), rpipe.cast(stree, torch.bfloat16)
    t = _Tally()
    worst: Dict[str, str] = {}
    with torch.inference_mode():
        for frames_np, out in batches:
            frames = torch.as_tensor(frames_np, device=device)
            _detect(t, out, rpipe.candidates(ytree, frames, cfg, traffic),
                    rpipe.candidates(y16, frames, cfg, traffic), traffic)
            valid = np.asarray(out["valid"], bool)
            boxes = torch.as_tensor(np.asarray(out["boxes"]), device=device, dtype=torch.float32)
            vt = torch.as_tensor(valid, device=device)
            refs = []
            for tree in (stree, s16):
                emb = rpipe.embed(tree, frames, cfg, traffic)
                refs.append(rpipe.crops(tree, emb, boxes, vt, frames.shape[1:], cfg, traffic))
                del emb
            _segment(t, out, refs[0], refs[1], valid)
            del refs
            _metrics(t, out, frames, worst)
    got = {
        "box_ratio": _ratio(t["box_sq"], t["box16_sq"]) ** 0.5,
        "score_ratio": _ratio(t["score"], t["score16"]),
        "nms_gap_ratio": _ratio(t["gap"], t["score16"]),
        "nms_overlap": int(t["nms_overlap"]),
        "det_miss": int(t["det_miss"]),
        "offset_miss": int(t["offset_miss"]),
        "slot_miss": int(t["slot_miss"]),
        "mask_flip_ratio": _ratio(t["flips"], t["flips16"]),
        "mask_gap_ratio": _ratio(t["mask_gap"], t["mask_gap16"]),
        "metric_exact_miss": int(t["metric_exact_miss"]),
        "metric_rel": t["metric_rel"],
    }
    worst["yardstick"] = (f"bf16 reference: box {t['box16']!r} strides, score {t['score16']!r}, "
                          f"{int(t['flips16'])} of {int(t['pixels'])} pixels flipped, widest "
                          f"|logit| {t['mask_gap16']!r}; program: box {t['box']!r}, score "
                          f"{t['score']!r}, nms gap {t['gap']!r}, {int(t['flips'])} flipped, "
                          f"widest {t['mask_gap']!r}; {int(t['stops'])} frames stopped short of "
                          f"max_det")
    return got, worst


def verdict(got: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    that has a limit in the cell's file is at most it and finite. A number
    whose control readings do not reach three times its sound ones gets no
    limit there, and is only reported (``PERF.md`` says which and why)."""
    table = {k: {"value": got[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
