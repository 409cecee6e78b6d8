"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m cytobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the cell's frames and weights from
the seed (the weights on the card), builds the port's pipeline with them
(``params=``), and runs the stream until every kernel is built and every
shape warm. The window then drives the engine's overlapped batch stream for
``--seconds``: ``_dispatch_batch(frames, fetch_masks=True)`` with the
traffic's batches in flight, ``_fetch_outputs`` of the oldest, host uint8
frames in and host rows and bitpacked crops out. With ``--trace 1`` the
same window is followed by a few batches through the synchronised stage
path (``process_batch_arrays`` with timings) and a ``torch.profiler``
window of the steady stream, and the per-layer metrics are printed instead
of the end-to-end ones. After the window, the pipeline freed, sampled
batches of the window are judged against the plain fp32 reference
(``cytobench/judge.py``).

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with its limit);
the compared numbers are also the last lines of standard error. Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo_sam_inference_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared as whole names."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def build_pipeline(cfg: Dict, traffic: Dict, seed: int, device, quant: str = "none"):
    """The port's pipeline for a configuration and a traffic mix, on weights
    drawn from ``seed`` (``cytobench/weights.py``): its model family's
    ``build``."""
    from .manifest import family

    return family(cfg).build(cfg, traffic, seed, device, quant)


def port_pipeline(cfg: Dict, traffic: Dict, seed: int, device, quant: str, sam_config,
                  sam_encoder_size: int):
    """The port's pipeline from what every family shares: YOLOv8 from the
    configuration's ``yolo``, the engine's options from the traffic mix,
    the weights from ``seed``; SAM as the family configures it."""
    import torch

    from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
    from yolo_sam_inference_tpu_torch.pipeline.engine import (
        CellSegmentationPipeline,
        PipelineOptions,
    )

    from . import flops, weights

    y = cfg["yolo"]
    ycfg = YoloConfig(depth_mult=y["depth_multiple"], width_mult=y["width_multiple"],
                      max_channels=y["max_channels"], num_classes=y["nc"], reg_max=y["reg_max"])
    opts = PipelineOptions(
        batch_size=traffic["batch"], max_det=traffic["max_det"],
        metric_crop=traffic["metric_crop"], conf_threshold=traffic["conf_threshold"],
        iou_threshold=traffic["iou_threshold"], nms_candidates=traffic["nms_candidates"],
        yolo_size=flops.yolo_size(traffic), sam_encoder_size=sam_encoder_size,
        compute_dtype=getattr(torch, cfg["dtype"]), quant=quant)
    params = weights.weights(cfg, seed, device, host=True)
    return CellSegmentationPipeline(device=device, options=opts, sam_config=sam_config,
                                    yolo_config=ycfg, params=params)


class Stream:
    """The engine's overlapped batch stream: each step dispatches the next
    batch of the pool and, with more than ``inflight`` batches out, fetches
    the oldest. Keeps ``keep`` fetched batches, a uniform sample drawn with
    ``rng`` (reservoir sampling), for the comparison."""

    def __init__(self, pipe, pool, inflight: int, keep: int = 0, rng=None, mark: bool = False):
        self.pipe, self.pool, self.inflight = pipe, pool, inflight
        self.keep, self.rng, self.mark = keep, rng, mark
        self.pending: collections.deque = collections.deque()
        self.i = self.images = self.fetched = 0
        self.batch_s: List[float] = []
        self.dispatch_s: List[float] = []
        self.kept: List = []

    def _phase(self, name: str):
        from torch.profiler import record_function

        return record_function(name) if self.mark else contextlib.nullcontext()

    def step(self) -> None:
        idx = self.i % len(self.pool)
        t0 = time.perf_counter()
        with self._phase("dispatch"):
            h = self.pipe._dispatch_batch(self.pool[idx], fetch_masks=True)
        self.dispatch_s.append(time.perf_counter() - t0)
        self.pending.append((t0, idx, h))
        self.i += 1
        if len(self.pending) > self.inflight:
            self.fetch()

    def fetch(self) -> None:
        t0, idx, h = self.pending.popleft()
        with self._phase("fetch"):
            out = self.pipe._fetch_outputs(h)
        self.batch_s.append(time.perf_counter() - t0)
        self.images += len(self.pool[idx])
        self.fetched += 1
        if len(self.kept) < self.keep:
            self.kept.append((idx, out))
        elif self.keep:
            j = int(self.rng.integers(self.fetched))
            if j < self.keep:
                self.kept[j] = (idx, out)

    def drain(self) -> None:
        while self.pending:
            self.fetch()


def _card() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(manifest, name: str, seed: int, seconds: float, trace: bool, device,
             quant: str = "none") -> Dict:
    """One run of a cell on ``device``; returns the result line's object.
    ``quant="int8"`` runs the program's w8a8 encoder path (the control of
    ``cytobench/control.py``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import judge, trace as tracing, traffic as gen, weights

    seed = int(seed) % (1 << 63)  # any whole number; numpy's generators take none below 0
    cell = manifest.cell(name)
    cfg, traffic = manifest.config(cell), manifest.traffic(cell)
    limits = manifest.limits(cell)
    os.environ["E2E_INFLIGHT"] = str(traffic["inflight"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    pool = gen.frame_pool(seed, traffic)
    pipe = build_pipeline(cfg, traffic, seed, device, quant)
    warm = Stream(pipe, pool, traffic["inflight"])
    for _ in range(traffic["warmup_batches"]):
        warm.step()
    warm.drain()
    if trace:  # the synced stage path's first pass
        pipe.process_batch_arrays(pool[0], {})
    sync()
    rec: Dict = {"cell": name, "config": cfg, "traffic": traffic,
                 "setup_s": time.perf_counter() - T0}

    s = Stream(pipe, pool, traffic["inflight"], traffic["check_batches"],
               np.random.default_rng(seed))
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        s.step()
    s.drain()
    rec["window"] = {"seconds": time.perf_counter() - t_start, "images": s.images,
                     "batches": s.fetched, "batch_s": s.batch_s, "dispatch_s": s.dispatch_s}
    attempted = s.i * traffic["batch"]

    if trace:
        stages: Dict[str, List[float]] = {}
        for j in range(traffic["synced_batches"]):
            timings: Dict[str, float] = {}
            pipe.process_batch_arrays(pool[j % len(pool)], timings)
            for k, v in timings.items():
                stages.setdefault(k, []).append(v)
        rec["stages"] = stages
        prof_stream = Stream(pipe, pool, traffic["inflight"], mark=True)
        for _ in range(traffic["inflight"]):
            prof_stream.step()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        rec["encoder_images"] = []
        encoder = manifest.family(cfg).ENCODER_CLASS
        with profile(activities=acts) as prof, tracing.mark_encoder(rec["encoder_images"], encoder):
            with record_function(tracing.WINDOW):
                for _ in range(traffic["profiled_batches"]):
                    prof_stream.step()
            sync()
        prof_stream.drain()
        rec["profile"] = tracing.read(prof.events())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    del pipe, warm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    trees = weights.weights(cfg, seed, device, host=False)
    got, worst = judge.numbers(cfg, traffic, trees, [(pool[i], out) for i, out in s.kept],
                               device)
    correct, table = judge.verdict(got, limits)
    for k, v in worst.items():
        print(f"judged {k}: {v}", file=sys.stderr)
    for k in sorted(set(got) - set(table)):
        print(f"judged {k} (no limit in this cell): {got[k]!r}", file=sys.stderr)
    del trees

    metrics = {}
    for m in manifest.metrics(cell, trace):
        v = manifest.reader(m, trace)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"] if cuda else 0, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": attempted - s.images, "metrics": metrics, "device": dev}
    if trace:
        p = rec["profile"]
        if p:
            dev["busy_s"], dev["window_s"] = p["busy_s"], p["window_s"]
            line["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
        print(json.dumps({"stages_s": rec["stages"], "encoder_images": rec["encoder_images"],
                          "encoder_s": rec["profile"].get("encoder_s")}), file=sys.stderr)
    line["compared"] = table
    return line


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from .manifest import Manifest

    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cytobench: the cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"card: {_card()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    line = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"cytobench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in line["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
