"""The port's span recorder (``utils/spans.py``) and the engine's spans, on the
CPU: off it does nothing; on, the spans of a dispatch and a fetch form the
batch stream's tree, the outputs are the same bits, the clock is the
profiler's, and each thread keeps its own parents. A tiny fp32 pipeline
(``sam_tiny_test()``, YOLOv8n at a 64-pixel letterbox) on 64x64 frames."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from synth import make_cell_image
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.utils import spans

torch.set_num_threads(1)

OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64)
STAGES = ("detect", "embed", "segment", "metrics")
# the batch stream's tree: each span and its parent
TREE = [("dispatch", None), ("slot_wait", "dispatch"), ("upload", "dispatch"),
        ("detect", "dispatch"), ("embed", "dispatch"), ("segment", "dispatch"),
        ("metrics", "dispatch"), ("nms", "detect"), ("pack", "dispatch"), ("fetch", None),
        ("fetch_wait", "fetch"), ("unpack", "fetch")]


class _Done:
    """A slot's copies-done event on the CPU, where there is none to wait on."""

    def synchronize(self):
        pass


@pytest.fixture(scope="module")
def pipe():
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return [np.stack([make_cell_image(rng, 64, 64) for _ in range(2)]) for _ in range(4)]


def _stream(pipe, frames):
    """Four batches two in flight, as the benchmark's stream drives them:
    the fourth dispatch reuses the first batch's slot."""
    pending, outs = [], []
    for f in frames:
        pending.append(pipe._dispatch_batch(f, fetch_masks=True))
        if len(pending) > 2:
            outs.append(pipe._fetch_outputs(pending.pop(0)))
    outs += [pipe._fetch_outputs(h) for h in pending]
    return outs


@pytest.fixture(scope="module")
def recorded(pipe, frames):
    """The stream under a recording, each slot with a copies-done event so
    that the waits are spans too; and the same stream with nothing on."""
    off = _stream(pipe, frames)
    record = tengine._Slot.record
    tengine._Slot.record = lambda self: setattr(self, "done", _Done())
    try:
        with spans.recording() as rec:
            on = _stream(pipe, frames)
    finally:
        tengine._Slot.record = record
        for s in pipe._slots:
            s.done = None
    return rec, off, on


def _flat(out):
    flat = {k: v for k, v in out.items() if k != "metrics"}
    flat.update({"metrics." + k: v for k, v in out["metrics"].items()})
    return flat


@pytest.mark.parametrize("entry", ["span", "stream", "synced"])
def test_off_records_nothing_and_enters_no_range(pipe, frames, monkeypatch, entry):
    entered = []
    monkeypatch.setattr(spans, "record_function", lambda name: entered.append(name))
    if entry == "span":
        assert spans.span("dispatch") is spans.OFF
        assert spans.span("fetch", 3) is spans.OFF
        with spans.span("detect") as s:
            assert s is None
    elif entry == "stream":
        _stream(pipe, frames)
    else:
        pipe.process_batch_arrays(frames[0], {})
    assert spans._active is None and entered == []


def test_outputs_bit_equal_with_the_recorder_on(recorded):
    _, off, on = recorded
    assert len(off) == len(on) == 4
    for a, b in zip(off, on):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("name,parent", TREE)
def test_stream_spans_form_the_tree(recorded, name, parent):
    rec = recorded[0]
    mine = [s for s in rec.spans if s.name == name]
    # one a batch; the slot wait only where a slot is reused (the fourth dispatch)
    assert len(mine) == (1 if name == "slot_wait" else 4)
    for s in mine:
        if parent is None:
            assert s.parent is None
            continue
        p = rec.spans[s.parent]
        assert p.name == parent
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        assert s.batch == p.batch and s.thread == p.thread


def test_dispatch_and_fetch_share_a_batch_id(recorded):
    rec = recorded[0]
    dispatch = [s.batch for s in rec.spans if s.name == "dispatch"]
    fetch = [s.batch for s in rec.spans if s.name == "fetch"]
    assert len(set(dispatch)) == 4 and None not in dispatch
    assert fetch == dispatch  # fetched in the order dispatched
    for b in dispatch:
        d = next(s for s in rec.spans if s.name == "dispatch" and s.batch == b)
        f = next(s for s in rec.spans if s.name == "fetch" and s.batch == b)
        assert d.end_ns <= f.start_ns
    kids = {s.name for s in rec.spans if s.parent is not None
            and rec.spans[s.parent].name == "dispatch"}
    assert kids == {"slot_wait", "upload", "pack", *STAGES}


def test_synced_path_gives_the_stage_spans(pipe, frames):
    timings = {}
    with spans.recording() as rec:
        pipe.process_batch_arrays(frames[0], timings)
    assert set(timings) == {"yolo_detection", "sam_preprocess", "sam_inference_total",
                            "metrics_total"}
    top = [s.name for s in rec.spans if s.parent is None]
    assert [n for n in top if n in STAGES] == list(STAGES)
    assert "dispatch" not in top
    nms = next(s for s in rec.spans if s.name == "nms")
    assert rec.spans[nms.parent].name == "detect"


def test_spans_are_on_the_profilers_clock(pipe, frames):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the profiler's first range pays its set-up
            pass
        with spans.recording() as rec:
            _stream(pipe, frames[:3])
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        ranges.setdefault(e.name, []).append(e)
    seen = {}
    assert len(rec.spans) > 20
    for s in rec.spans:
        e = ranges[s.name][seen.setdefault(s.name, 0)]
        seen[s.name] += 1
        start, end = t0 + e.time_range.start * 1000, t0 + e.time_range.end * 1000
        assert abs(s.start_ns - start) < 5e5 and abs(s.end_ns - end) < 5e5, s.name
        assert start <= s.start_ns + 5e4 and s.end_ns <= end + 5e4, s.name
    assert seen == {n: len(v) for n, v in ranges.items() if n in seen}


def test_threads_keep_their_own_parents():
    barrier = threading.Barrier(2)

    def run(name):
        with spans.span(name, batch=len(name)):
            barrier.wait()
            with spans.span(name + ".inner"):
                barrier.wait()

    with spans.recording() as rec:
        threads = [threading.Thread(target=run, args=(n,)) for n in ("a", "bb")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"a", "bb", "a.inner", "bb.inner"}
    for n in ("a", "bb"):
        inner = by[n + ".inner"]
        assert rec.spans[inner.parent] is by[n] and by[n].parent is None
        assert inner.batch == len(n) and inner.thread == by[n].thread
    assert by["a"].thread != by["bb"].thread


def test_a_recording_inside_another_takes_its_own_spans():
    with spans.recording() as outer:
        with spans.span("before"):
            pass
        with spans.recording() as inner:
            with spans.span("inside"):
                pass
        with spans.span("after"):
            pass
    assert [s.name for s in outer.spans] == ["before", "after"]
    assert [s.name for s in inner.spans] == ["inside"]
    assert spans.span("after") is spans.OFF
