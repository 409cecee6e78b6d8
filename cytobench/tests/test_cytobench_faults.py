"""A run of the tiny cell on the CPU, with the harness's look for a card
skipped: sound, it is correct; with the timed path broken underneath, in each
way this cell's path can break, ``correct`` comes out false."""

import pytest
import torch

from cytobench import run
from cytobench.manifest import Manifest
from yolo_sam_inference_tpu_torch.pipeline import engine

from . import tiny


def _run(root, seed=11):
    return run.run_cell(Manifest(root, root / "cytobench"), tiny.CELL, seed, 0.5, False, "cpu")


def _shift_a_box(orig):
    def detect(*a, **k):
        boxes, scores, valid = orig(*a, **k)
        return boxes + torch.where(torch.arange(boxes.shape[0])[:, None, None] == 0, 7.0, 0.0) \
            * valid[..., None], scores, valid
    return detect


def _flip_a_mask(orig):
    def segment(*a, **k):
        crops, offs = orig(*a, **k)
        crops = crops.clone()
        crops[0, 0] = ~crops[0, 0]
        return crops, offs
    return segment


def _alter_a_metric(orig):
    def metrics(*a, **k):
        out = dict(orig(*a, **k))
        out["perimeter"] = out["perimeter"].clone()
        out["perimeter"][0, 0] *= 1.01
        return out
    return metrics


def _half_batch(orig):
    def fused_call(self, images):
        half = images.shape[0] // 2
        outs = orig(self, images[:half])
        rep = lambda t: torch.cat([t, t[:images.shape[0] - half]])  # noqa: E731
        return (*[rep(t) for t in outs[:5]], {k: rep(v) for k, v in outs[5].items()})
    return fused_call


def _empty_frames(share):
    """Detection that answers nothing for the last ``share`` of the batch."""
    def make(orig):
        def detect(*a, **k):
            boxes, scores, valid = orig(*a, **k)
            keep = torch.arange(boxes.shape[0]) < boxes.shape[0] - int(boxes.shape[0] * share)
            valid = valid & keep[:, None]
            return boxes * valid[..., None], scores * valid, valid
        return detect
    return make


def test_sound_run_is_correct(tiny_root):
    line = _run(tiny_root)
    assert line["correct"], line["compared"]


@pytest.mark.parametrize("where,make", [
    ("detect_stage", _shift_a_box),
    ("segment_stage", _flip_a_mask),
    ("metrics_stage", _alter_a_metric),
    ("fused_call", _half_batch),
])
def test_fault_is_not_correct(tiny_root, monkeypatch, where, make):
    if where == "fused_call":
        monkeypatch.setattr(engine.CellSegmentationPipeline, "fused_call",
                            make(engine.CellSegmentationPipeline.fused_call))
    else:
        monkeypatch.setattr(engine, where, make(getattr(engine, where)))
    line = _run(tiny_root)
    assert not line["correct"], line["compared"]


def test_sound_run_is_correct_under_vith_limits(tiny_root_vith):
    line = _run(tiny_root_vith)
    assert line["correct"], line["compared"]


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_frames_left_empty_are_not_correct(tiny_root_vith, monkeypatch, share):
    """Half of the batch, or all of it, answered with no detection: under
    the limits of the cell that compares no NMS gap, ``det_miss`` fails it."""
    monkeypatch.setattr(engine, "detect_stage", _empty_frames(share)(engine.detect_stage))
    line = _run(tiny_root_vith)
    assert "nms_gap_ratio" not in line["compared"]
    assert line["compared"]["det_miss"]["value"] > 0
    assert not line["correct"], line["compared"]
