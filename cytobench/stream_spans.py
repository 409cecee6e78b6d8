"""The engine's spans in the steady batch stream of a cell, on the host and on
the card's trace.

    python3 -m cytobench.stream_spans --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on a card. Set-up is ``cytobench.run``'s (the
cell's frames and weights from the seed, the pipeline, the stream warmed);
then three phases of the stream:

- the window: ``--seconds`` of the stream with nothing recording, its mean
  ``_dispatch_batch`` host ms (``dispatch_ms``'s reading);
- (S) :data:`HOST_BATCHES` batches under ``spans.recording()``, with no
  profiler, after ``inflight`` warm steps: each span's host ms a batch
  (:func:`host_summary`);
- (B) a ``torch.profiler`` window of the traffic's ``profiled_batches``
  batches under ``spans.recording()``, marked :data:`WINDOW`: the device
  work each span launched, the blocking runtime calls, the idle time by the
  innermost span the host was in (:func:`read_device`).

Standard error gets the span table and the idle split; the last line of
standard output is one JSON object: the 14 numbers read by
``cytobench/metrics/<name>.py`` (:data:`METRICS`), the window's
``dispatch_ms``, and both summaries. The spans are the program's
(``yolo_sam_inference_tpu_torch/utils/spans.py``); a program without them
gives no reading (:func:`phases` returns ``{}``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import time
from typing import Dict, List, Optional

from .trace import RUNTIME, _merge

WINDOW = "cytobench.spans_window"
STAGES = ("detect", "embed", "segment", "metrics")
SPAN_NAMES = ("dispatch", "slot_wait", "upload", *STAGES, "nms", "pack", "fetch", "fetch_wait",
              "unpack")
HOST_BATCHES = 16
# calls that block the host until the card has caught up: the runtime's (`cuda*`) and
# the `cu*` synchronisations, and every copy that is not asynchronous
BLOCKING = re.compile(r"cu(da)?(Stream|Device|Ctx|Event)Synchronize|cu(da)?Memcpy(?!.*Async)")
METRICS = ("detect_host_ms", "embed_host_ms", "segment_host_ms", "metrics_host_ms",
           "nms_host_ms", "unpack_ms", "fetch_wait_ms", "detect_device_ms", "embed_device_ms",
           "segment_device_ms", "metrics_device_ms", "launches_per_batch", "dispatch_syncs",
           "dispatch_sync_ms")


# ------------------------------------------------------------------ (S): the host


def _paths(spans) -> List[str]:
    """Each span's path from its root, e.g. ``dispatch/detect/nms``."""
    out: List[str] = []
    for s in spans:
        out.append(s.name if s.parent is None else f"{out[s.parent]}/{s.name}")
    return out


def host_summary(spans) -> Dict:
    """{"batches", "total_ms", "self_ms"} of recorded spans: for each path,
    the mean over the batches of its root span of the path's inclusive
    (total) and exclusive (self: less its children) host ms in a batch. A
    path a batch lacks counts 0 there. Open spans are left out."""
    done = [s.end_ns is not None for s in spans]
    paths = _paths(spans)
    child_ms = [0.0] * len(spans)
    for s, ok in zip(spans, done):
        if ok and s.parent is not None:
            child_ms[s.parent] += s.ms
    total: Dict[str, float] = {}
    own: Dict[str, float] = {}
    roots: Dict[str, set] = {}
    for i, (s, p) in enumerate(zip(spans, paths)):
        if not done[i]:
            continue
        total[p] = total.get(p, 0.0) + s.ms
        own[p] = own.get(p, 0.0) + s.ms - child_ms[i]
        if s.parent is None:
            roots.setdefault(p, set()).add(s.batch)
    n = {p: len(roots.get(p.split("/")[0], ())) or 1 for p in total}
    return {"batches": {r: len(b) for r, b in roots.items()},
            "total_ms": {p: total[p] / n[p] for p in total},
            "self_ms": {p: own[p] / n[p] for p in own}}


# ---------------------------------------------------------------- (B): the card


def launched(cpu_sorted, starts, device_by_id, r) -> List:
    """The device work (kernels, copies, memsets) that the runtime calls
    inside the CPU range ``r``, on its thread, launched: a device event and
    the call that launched it share a correlation id (``cytobench/trace.py``
    reads the encoder's time so). ``cpu_sorted`` are the runtime calls in
    start order, ``starts`` their starts."""
    a, b = r.time_range.start, r.time_range.end
    out = []
    for e in cpu_sorted[bisect.bisect_left(starts, a):bisect.bisect_right(starts, b)]:
        if e.thread == r.thread and e.time_range.end <= b:
            out += device_by_id.get(e.id, ())
    return out


def _inside(e, ranges) -> bool:
    return any(r.thread == e.thread and r.time_range.start <= e.time_range.start
               and e.time_range.end <= r.time_range.end for r in ranges)


def read_device(events) -> Dict:
    """What a profiler window (the CPU range :data:`WINDOW`) of the stream
    under ``spans.recording()`` shows, a batch (over the ``dispatch`` ranges
    in the window); {} where it has no window, no dispatch or no device work:

    - ``stage_device_ms``: for each stage range inside a ``dispatch``, the
      union of the intervals of the device work it launched;
    - ``launches``: the device events launched inside ``dispatch``;
    - ``syncs``, ``sync_ms``: the blocking runtime calls (:data:`BLOCKING`)
      inside ``dispatch`` but outside ``slot_wait``, and their host ms. The
      profiler slows the host, so the host ms are a lower bound of what the
      card then holds the host back by;
    - ``busy_ms``, ``window_ms``: the union of all device intervals in the
      window, and the window;
    - ``idle_ms``: the window's idle time by the innermost span (its path)
      the host was in, "none" outside every span.
    """
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == WINDOW]
    if not win:
        return {}
    w = win[0]
    w0, w1 = w.time_range.start, w.time_range.end
    marks = set(SPAN_NAMES) | {WINDOW}
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in marks
              and not getattr(e, "is_user_annotation", False)]
    ranges = {n: [e for e in cpu if e.name == n and e.thread == w.thread
                  and w0 <= e.time_range.start and e.time_range.end <= w1] for n in SPAN_NAMES}
    n = len(ranges["dispatch"])
    if not n or not device:
        return {}
    runtime = sorted((e for e in cpu if RUNTIME.match(e.name)), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in runtime]
    by_id: Dict[int, List] = {}
    for e in device:
        by_id.setdefault(e.id, []).append(e)

    def union_ms(evs) -> float:
        return sum(b - a for a, b in _merge([(e.time_range.start, e.time_range.end)
                                              for e in evs])) / 1e3

    stage_ms = {s: sum(union_ms(launched(runtime, starts, by_id, r)) for r in ranges[s]
                       if _inside(r, ranges["dispatch"])) / n for s in STAGES}
    launches = sum(len(launched(runtime, starts, by_id, r)) for r in ranges["dispatch"])
    blocking = [e for e in runtime if BLOCKING.match(e.name) and _inside(e, ranges["dispatch"])
                and not _inside(e, ranges["slot_wait"])]
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device
                   if e.time_range.end > w0 and e.time_range.start < w1])
    return {
        "batches": n,
        "stage_device_ms": stage_ms,
        "launches": launches / n,
        "syncs": len(blocking) / n,
        "sync_ms": sum(e.time_range.end - e.time_range.start for e in blocking) / 1e3 / n,
        "sync_calls": sorted({e.name for e in blocking}),
        "busy_ms": sum(b - a for a, b in busy) / 1e3 / n,
        "window_ms": (w1 - w0) / 1e3 / n,
        "idle_ms": {k: v / n for k, v in _idle_by_span(w0, w1, busy, ranges).items()},
    }


def _idle_by_span(w0, w1, busy, ranges) -> Dict[str, float]:
    """The idle ms of [w0, w1] (outside ``busy``) by the innermost span range
    open on the host, named by its path of enclosing ranges."""
    spans = sorted((r for rs in ranges.values() for r in rs),
                   key=lambda r: (r.time_range.start, -r.time_range.end))
    path: Dict[int, str] = {}
    open_: List = []
    for r in spans:
        while open_ and open_[-1].time_range.end < r.time_range.end:
            open_.pop()
        path[id(r)] = "/".join([o.name for o in open_] + [r.name])
        open_.append(r)
    cuts = sorted({w0, w1} | {t for r in spans for t in (r.time_range.start, r.time_range.end)
                              if w0 < t < w1})
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    ends = [g1 for _, g1 in gaps]
    out: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        i, idle = bisect.bisect_right(ends, a), 0.0
        while i < len(gaps) and gaps[i][0] < b:
            idle += min(b, gaps[i][1]) - max(a, gaps[i][0])
            i += 1
        if idle <= 0:
            continue
        live = [r for r in spans if r.time_range.start <= a and b <= r.time_range.end]
        key = path[id(max(live, key=lambda r: r.time_range.start))] if live else "none"
        out[key] = out.get(key, 0.0) + idle / 1e3
    return out


# ---------------------------------------------------------------------- phases


def phases(pipe, pool, traffic: Dict, cuda: bool) -> Dict:
    """(S) and (B) on the steady stream: {"spans": :func:`host_summary`,
    "span_trace": :func:`read_device`}, or {} where the program has no
    spans."""
    try:
        from yolo_sam_inference_tpu_torch.utils import spans
    except ImportError:
        return {}
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .run import Stream

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inflight = traffic["inflight"]
    s = Stream(pipe, pool, inflight)
    for _ in range(inflight):
        s.step()
    with spans.recording() as rec:
        for _ in range(HOST_BATCHES):
            s.step()
    s.drain()
    sync()

    s = Stream(pipe, pool, inflight)
    for _ in range(inflight):
        s.step()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with spans.recording(), profile(activities=acts) as prof:
        with record_function("cytobench.spans_warm"):  # the profiler's first range pays its set-up
            pass
        with record_function(WINDOW):
            for _ in range(traffic["profiled_batches"]):
                s.step()
        sync()
    s.drain()
    return {"spans": host_summary(rec.spans), "span_trace": read_device(prof.events())}


def measure(manifest, name: str, seed: int, seconds: float, device) -> Dict:
    """One cell: set-up, the window (nothing recording), then :func:`phases`;
    returns the record the readers take, with ``metrics``."""
    import torch

    from . import run, traffic as gen

    seed = int(seed) % (1 << 63)
    cell = manifest.cell(name)
    cfg, traffic = manifest.config(cell), manifest.traffic(cell)
    os.environ["E2E_INFLIGHT"] = str(traffic["inflight"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pool = gen.frame_pool(seed, traffic)
    pipe = run.build_pipeline(cfg, traffic, seed, device)
    warm = run.Stream(pipe, pool, traffic["inflight"])
    for _ in range(traffic["warmup_batches"]):
        warm.step()
    warm.drain()
    sync()
    s = run.Stream(pipe, pool, traffic["inflight"])
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s.step()
    s.drain()
    rec: Dict = {"cell": name, "seed": seed,
                 "dispatch_ms": 1e3 * sum(s.dispatch_s) / len(s.dispatch_s)}
    rec.update(phases(pipe, pool, traffic, cuda))
    rec["metrics"] = {}
    for m in METRICS:
        v = manifest.reader({"name": m}, True)(rec)
        if v is not None:
            rec["metrics"][m] = v
    return rec


def table(rec: Dict) -> str:
    """The span table (host ms a batch, (S)) and the idle split ((B))."""
    h, d = rec.get("spans"), rec.get("span_trace")
    if not h:
        return "no spans: the program records none"
    lines = [f"{'span':34s} {'total ms':>10s} {'self ms':>10s}   (S), a batch"]
    for p in sorted(h["total_ms"], key=lambda p: (p.split("/")[0] != "dispatch", p)):
        lines.append(f"{p:34s} {h['total_ms'][p]:10.3f} {h['self_ms'][p]:10.3f}")
    dispatch = h["total_ms"].get("dispatch")
    if dispatch:
        kids = sum(v for p, v in h["total_ms"].items() if p.count("/") == 1
                   and p.startswith("dispatch/"))
        lines.append(f"children of dispatch cover {100 * kids / dispatch:.1f}% of it; the "
                     f"window's dispatch_ms {rec.get('dispatch_ms', float('nan')):.3f}")
    if d:
        stages = {k: round(v, 3) for k, v in d["stage_device_ms"].items()}
        lines.append(f"(B), a batch: busy {d['busy_ms']:.3f} of {d['window_ms']:.3f} ms; stage "
                     f"device ms {json.dumps(stages)}; "
                     f"launches {d['launches']:.1f}; blocking calls {d['syncs']:.1f} "
                     f"({d['sync_ms']:.3f} ms: {', '.join(d['sync_calls'])})")
        for k, v in sorted(d["idle_ms"].items(), key=lambda x: -x[1]):
            lines.append(f"  idle {v:9.3f} ms in {k}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=32.0)
    args = ap.parse_args(argv)

    from .run import ROOT, _card

    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    import torch

    from .manifest import Manifest

    if not torch.cuda.is_available():
        print("cytobench.stream_spans: no CUDA card", file=sys.stderr)
        return 3
    card = _card()
    rec = measure(Manifest(ROOT), args.workload, args.seed, args.seconds, "cuda")
    rec["card"] = f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
    print(f"{args.workload} seed {args.seed}: {rec['card']}\n{table(rec)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
