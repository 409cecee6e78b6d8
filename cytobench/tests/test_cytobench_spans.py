"""The readings of the engine's spans (``cytobench/stream_spans.py``): the
device trace's arithmetic on events made by hand (no card here), the host
summary on spans made by hand, and the phases on the tiny cell on the CPU."""

import importlib.util
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from cytobench import stream_spans as ss
from cytobench.manifest import Manifest
from yolo_sam_inference_tpu_torch.utils.spans import Span

from . import tiny

CUDA = DeviceType.CUDA


def _ev(name, start, end, dev=DeviceType.CPU, id=0, thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=dev, id=id, thread=thread, is_user_annotation=False)


def _events():
    """One batch's dispatch in a window, times in microseconds."""
    return [
        _ev(ss.WINDOW, 0, 1000),
        _ev("dispatch", 10, 400),
        _ev("slot_wait", 12, 20),
        _ev("cudaEventSynchronize", 13, 15),  # the slot's wait: not counted
        _ev("cudaStreamSynchronize", 15, 19),
        _ev("detect", 20, 100),
        _ev("cudaLaunchKernel", 21, 22, id=1),
        _ev("nms", 30, 90),
        _ev("cudaLaunchKernel", 31, 32, id=2),
        _ev("cudaStreamSynchronize", 40, 60, id=3),  # blocks inside detect
        _ev("aten::add", 61, 62, id=4),  # an operator's id is no launch's
        _ev("embed", 100, 200),
        _ev("cudaLaunchKernel", 101, 102, id=5),
        _ev("cudaMemcpyAsync", 103, 104, id=6),
        _ev("cudaLaunchKernel", 105, 106, id=12, thread=2),  # another thread
        _ev("segment", 200, 250),
        _ev("cuLaunchKernelEx", 201, 202, id=7),
        _ev("metrics", 250, 300),
        _ev("cudaLaunchKernel", 251, 252, id=8),
        _ev("cudaMemcpy", 260, 270, id=9),  # a copy that blocks
        _ev("pack", 300, 390),
        _ev("cudaLaunchKernel", 301, 302, id=10),
        _ev("fetch", 400, 600),  # outside dispatch: neither launches nor syncs
        _ev("cudaLaunchKernel", 401, 402, id=11),
        _ev("cudaStreamSynchronize", 410, 420, id=13),
        _ev("gemm", 50, 80, CUDA, id=1),
        _ev("nms_step", 70, 120, CUDA, id=2),
        _ev("add_kernel", 120, 130, CUDA, id=4),  # no runtime call of this id
        _ev("encoder", 150, 300, CUDA, id=5),
        _ev("Memcpy HtoD", 300, 310, CUDA, id=6),
        _ev("decoder", 320, 330, CUDA, id=7),
        _ev("hull", 330, 335, CUDA, id=8),
        _ev("Memcpy DtoH", 340, 345, CUDA, id=9),
        _ev("pack_bits", 350, 360, CUDA, id=10),
        _ev("fetched", 700, 800, CUDA, id=11),
        _ev("other", 900, 950, CUDA, id=12),
        _ev("detect", 50, 60, CUDA, id=1),  # a span's mark on the device's timeline
    ]


def test_device_work_is_attributed_to_each_stage_by_correlation_id():
    d = ss.read_device(_events())
    assert d["batches"] == 1
    assert d["stage_device_ms"] == pytest.approx(
        {"detect": 0.070, "embed": 0.160, "segment": 0.010, "metrics": 0.010})


def test_launches_count_only_device_work_launched_inside_dispatch():
    # ids 1, 2, 5, 6, 7, 8, 9, 10: not the fetch's, the other thread's, an operator's
    assert ss.read_device(_events())["launches"] == 8


def test_syncs_count_blocking_calls_in_dispatch_outside_the_slot_wait():
    d = ss.read_device(_events())
    assert d["syncs"] == 2  # detect's cudaStreamSynchronize, metrics' cudaMemcpy
    assert d["sync_ms"] == pytest.approx(0.030)
    assert d["sync_calls"] == ["cudaMemcpy", "cudaStreamSynchronize"]


def test_idle_time_is_named_by_the_innermost_span():
    d = ss.read_device(_events())
    assert d["busy_ms"] == pytest.approx((80 + 160 + 15 + 5 + 10 + 100 + 50) / 1e3)
    idle = d["idle_ms"]
    assert idle["none"] == pytest.approx((10 + 100 + 100 + 50) / 1e3)  # outside every span
    assert idle["dispatch"] == pytest.approx((2 + 10) / 1e3)
    assert idle["dispatch/embed"] == pytest.approx(20 / 1e3)
    assert idle["dispatch/pack"] == pytest.approx((10 + 5 + 5 + 30) / 1e3)
    assert idle["dispatch/slot_wait"] == pytest.approx(8 / 1e3)
    assert idle["dispatch/detect"] == pytest.approx(10 / 1e3)
    assert idle["dispatch/detect/nms"] == pytest.approx(20 / 1e3)
    assert idle["fetch"] == pytest.approx(200 / 1e3)
    assert sum(idle.values()) == pytest.approx(d["window_ms"] - d["busy_ms"])


def test_no_window_or_no_dispatch_reads_nothing():
    ev = _events()
    assert ss.read_device(ev[1:]) == {}
    assert ss.read_device([e for e in ev if e.name != "dispatch"]) == {}


def _span(name, parent, batch, t0, t1):
    return Span(name, parent, batch, 1, int(t0 * 1e6), int(t1 * 1e6))


def test_host_summary_means_each_path_over_its_batches():
    spans = [_span("dispatch", None, 0, 0, 10), _span("detect", 0, 0, 1, 4),
             _span("nms", 1, 0, 2, 3), _span("slot_wait", 0, 0, 0, 1),
             _span("fetch", None, 7, 10, 12), _span("unpack", 4, 7, 10, 11),
             _span("dispatch", None, 1, 20, 26), _span("detect", 6, 1, 21, 22),
             _span("nms", 7, 1, 21, 21.5), _span("fetch", None, 8, 30, 34),
             _span("unpack", 9, 8, 31, 34), _span("dispatch", None, 2, 40, 41)]
    spans[-1].end_ns = None  # still open: left out
    h = ss.host_summary(spans)
    assert h["batches"] == {"dispatch": 2, "fetch": 2}
    t, s = h["total_ms"], h["self_ms"]
    assert t["dispatch"] == 8 and s["dispatch"] == pytest.approx((10 - 4 + 6 - 1) / 2)
    assert t["dispatch/detect"] == 2 and s["dispatch/detect"] == pytest.approx((2 + 0.5) / 2)
    assert t["dispatch/detect/nms"] == 0.75
    assert t["dispatch/slot_wait"] == 0.5  # one batch of two waited
    assert t["fetch/unpack"] == 2 and t["fetch"] == 3


@pytest.mark.parametrize("name", ss.METRICS)
def test_each_reader_reads_nothing_without_spans(name):
    spec = importlib.util.spec_from_file_location(name, tiny.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    base = {"window": {"dispatch_s": [0.1]}, "stages": {}, "profile": {}}
    assert mod.read(base) is None
    assert mod.read(dict(base, spans={}, span_trace={})) is None


def test_the_phases_on_the_tiny_cell(tiny_root):
    """On the CPU: the host's readings all come, the device's none (no card),
    and the dispatch's children cover it."""
    rec = ss.measure(Manifest(tiny_root, tiny_root / "cytobench"), tiny.CELL, 2**31 + 7, 0.3,
                     "cpu")
    host = {"detect_host_ms", "embed_host_ms", "segment_host_ms", "metrics_host_ms",
            "nms_host_ms", "unpack_ms"}
    assert set(rec["metrics"]) == host and all(v > 0 for v in rec["metrics"].values())
    assert rec["span_trace"] == {} and rec["dispatch_ms"] > 0
    h = rec["spans"]
    assert h["batches"] == {"dispatch": ss.HOST_BATCHES, "fetch": ss.HOST_BATCHES}
    kids = sum(v for p, v in h["total_ms"].items() if p.count("/") == 1
               and p.startswith("dispatch/"))
    assert 0.9 * h["total_ms"]["dispatch"] < kids <= h["total_ms"]["dispatch"]
    assert "children of dispatch cover" in ss.table(rec)
