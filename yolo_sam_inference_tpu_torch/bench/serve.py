"""Serving benchmark of the port: the micro-batching HTTP service on one card.

    python -m yolo_sam_inference_tpu_torch.bench.serve [--batch 128]
        [--inflight 256] [--requests 2048] [--masks] [--fmt json|bin]

The counterpart of the JAX package's ``tools/serve_bench.py`` with its
defaults: config 1's geometry (``BENCH_SAM``, default SAM ViT-B, with
YOLOv8n; max_det 16, metric_crop 128, random weights from seed 0), batch
128 of 512x512 frames, ``--inflight`` client threads posting raw uint8 bodies
over loopback, ``--warm-requests`` (256) unmeasured before ``--requests``
(2048) measured. It prints one JSON line: ``value`` img/s over the measured
requests, ``host_cpu_ms_per_request`` (the CPU time of this process — its
client threads and the server's together — over the measured requests; the
JAX bench read the whole host's busy time from ``/proc/stat``, which showed
no busy time on the card's machine), p50/p99 request
latency, ``mean_batch_fill``, ``errors``, ``warmup_s`` (the service's build
and first batch), ``inflight``, and ``card``, the card's name and power
limit. A failed run exits non-zero and prints no result line. The command
refuses to run without a card; :func:`run` takes ``device=`` (and a built
``pipeline=``) so that a test or ``chip_smoke.py`` can call it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serving benchmark (HTTP micro-batching)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--inflight", type=int, default=256)
    p.add_argument("--requests", type=int, default=2048)
    p.add_argument("--warm-requests", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=3.0)
    p.add_argument("--masks", action="store_true")
    p.add_argument("--fmt", choices=("json", "bin"), default="json",
                   help="response format: bin = packed fp32 records "
                        "(content-negotiated; cuts per-request host CPU)")
    args = p.parse_args(argv)
    if args.requests < 1:
        p.error("--requests must be at least 1")
    return args


def bench_frame(size: int, rng) -> np.ndarray:
    """The JAX bench's request frame: uniform noise with 8 bright disks."""
    img = rng.integers(0, 255, size=(size, size), dtype=np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for _ in range(8):
        cy, cx = rng.uniform(30, size - 30, 2)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 14 ** 2] = 200
    return img


def run(argv=None, device: str = "cuda", pipeline=None) -> dict:
    """The bench's result line at the arguments ``argv``; ``pipeline`` (its
    options' max_det and metric_crop are the caller's) replaces the one built
    from ``BENCH_SAM``."""
    from ..pipeline.engine import CellSegmentationPipeline, PipelineOptions
    from ..web.serve import serve
    from .common import card

    args = parse_args(argv)
    t0 = time.time()
    if pipeline is None:
        pipeline = CellSegmentationPipeline(
            sam_model_type=os.environ.get("BENCH_SAM", "facebook/sam-vit-base"), device=device,
            options=PipelineOptions(batch_size=args.batch, max_det=16, metric_crop=128),
        )
    server, service = serve(pipeline, host="127.0.0.1", port=0, batch_size=args.batch,
                            max_wait_ms=args.max_wait_ms, image_shape=(args.size, args.size))
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    try:
        warm_s = time.time() - t0
        query = [k for k, on in (("masks=1", args.masks), ("fmt=bin", args.fmt == "bin")) if on]
        url = f"http://127.0.0.1:{server.server_address[1]}/segment" + (
            "?" + "&".join(query) if query else "")
        body = bench_frame(args.size, np.random.default_rng(0)).tobytes()
        headers = {"Content-Type": "application/octet-stream",
                   "X-Shape": f"{args.size}x{args.size}"}

        lock = threading.Lock()
        latencies = []
        counter = {"left": args.warm_requests + args.requests, "measured": 0, "errors": 0}
        start = {}  # the first measured request's clock and host CPU

        def worker():
            while True:
                with lock:
                    if counter["left"] <= 0:
                        return
                    counter["left"] -= 1
                    measuring = counter["left"] < args.requests  # the last `requests`
                    if measuring and not start:
                        start["t"], start["cpu"] = time.perf_counter(), time.process_time()
                rt0 = time.perf_counter()
                try:
                    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
                    with urllib.request.urlopen(req, timeout=120) as r:
                        payload = r.read()
                    if args.fmt == "bin" and payload[:4] != b"YSB1":
                        raise ValueError("bad binary magic")
                except Exception:  # a failed request is counted, and the client goes on
                    with lock:
                        counter["errors"] += 1
                    continue
                if measuring:
                    with lock:
                        latencies.append(time.perf_counter() - rt0)
                        counter["measured"] += 1

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(args.inflight)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - start["t"]
        cpu_ms = (time.process_time() - start["cpu"]) * 1e3
        with service._lock:
            stats = dict(service.stats)
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        loop.join(timeout=5)
    # host-CPU ms per measured request (client and server share this
    # process): the number the binary response mode exists to cut
    lat_ms = np.sort(np.asarray(latencies)) * 1e3 if latencies else np.full(1, np.nan)
    on_card = pipeline.device.type == "cuda"
    return {
        "metric": "serving images/sec (HTTP micro-batching, "
                  f"B={args.batch}, {args.size}x{args.size}, {args.fmt})",
        "value": round(counter["measured"] / dt, 2),
        "unit": "images/sec",
        "host_cpu_ms_per_request": round(cpu_ms / max(counter["measured"], 1), 2),
        "p50_request_latency_ms": round(float(np.percentile(lat_ms, 50)), 1),
        "p99_request_latency_ms": round(float(np.percentile(lat_ms, 99)), 1),
        "mean_batch_fill": round(stats["images_batched"] / max(stats["batches"], 1), 1),
        "errors": counter["errors"],
        "warmup_s": round(warm_s, 1),
        "inflight": args.inflight,
        "card": card() if on_card else "cpu (no card)",
    }


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench/serve.py: no CUDA device (the bench measures the card)", file=sys.stderr)
        return 1
    print(json.dumps(run(argv, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
