"""End-to-end throughput of the port on one card: YOLO + SAM + metrics.

    python -m yolo_sam_inference_tpu_torch.bench.e2e

The counterpart of the JAX package's ``bench.py`` at its config-1 cell:
batch 128 of 512x512 frames from the same generator, max_det 16,
metric_crop 128, random weights from seed 0. It prints one JSON line:

* ``value``: img/s of the fused loop, ``BENCH_CHUNK`` batches a call through
  ``fused_call_chunked`` (frames already on the card, outputs left there);
* ``p50/p99_image_latency_ms``, ``p50_batch_latency_ms``: a loop of
  ``fused_call`` synchronised after every batch;
* with ``BENCH_E2E=1``, ``e2e_dir_ips`` and ``e2e_stages``:
  ``process_directory`` over ``BENCH_E2E_FILES`` mode-L PNG files written
  beforehand (decode, upload, the overlapped batches, fetch and CSV rows),
  and its ``last_directory_stats``;
* ``card``: the card's name and power limit.

Knobs: ``BENCH_SAM``, ``BENCH_QUANT``, ``BENCH_BATCH``, ``BENCH_ITERS``,
``BENCH_SIZE``, ``BENCH_MAX_DET``, ``BENCH_CHUNK``, ``BENCH_E2E``,
``BENCH_E2E_FILES``. A failed run exits non-zero and prints no result line;
there is no cached or fallback result. The command refuses to run without a
card; :func:`run` takes ``device=`` so that a test can run it on the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

LABELS = {"facebook/sam-vit-base": "SAM-ViT-B", "facebook/sam-vit-large": "SAM-ViT-L",
          "facebook/sam-vit-huge": "SAM-ViT-H", "mobile-sam": "MobileSAM"}


def bench_frames(batch: int, size: int, rng) -> np.ndarray:
    """uint8 (batch, size, size, 3) replicated-gray frames with 8 bright
    blobs each on one rolled noise field (the JAX ``bench.py``'s frames)."""
    base = rng.normal(40, 5, size=(size, size)).clip(0, 255)
    gray = np.stack([np.roll(base, 17 * b, axis=0) for b in range(batch)])
    for b in range(batch):
        for _ in range(8):
            cy, cx = rng.uniform(30, size - 30, 2)
            r = rng.uniform(8, 20)
            val = rng.uniform(150, 220)
            y0, y1 = max(0, int(cy - r)), min(size, int(cy + r) + 2)
            x0, x1 = max(0, int(cx - r)), min(size, int(cx + r) + 2)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            gray[b, y0:y1, x0:x1][blob] = val
    return np.repeat(gray.astype(np.uint8)[..., None], 3, axis=-1)


def _directory_leg(pipe, imgs: np.ndarray, n_files: int) -> dict:
    """``process_directory`` over ``n_files`` mode-L PNGs of ``imgs``, after
    warming the stage path and the overlapped path at the loader's shapes
    and building the PNG decoder."""
    from ..io.png_native import library
    from .common import write_png

    batch = imgs.shape[0]
    sb = min(int(os.environ.get("E2E_SAMPLE_BATCH", "32")), batch)
    pipe.process_batch_arrays(imgs[:sb, ..., 0], fetch_masks=False, fetch_outputs=False)
    pipe._fetch_outputs(pipe._dispatch_batch(imgs[..., 0], fetch_masks=False))
    library()
    with tempfile.TemporaryDirectory() as src, tempfile.TemporaryDirectory() as out:
        for i in range(n_files):
            write_png(f"{src}/img_{i:04d}.png", imgs[i % batch][..., 0])
        t0 = time.perf_counter()
        res = pipe.process_directory(src, out, save_visualizations=False, progress=False)
        dt = time.perf_counter() - t0
    return {"e2e_dir_ips": round(len(res.results) / dt, 2),
            "e2e_stages": pipe.last_directory_stats}


def run(device: str = "cuda") -> dict:
    """The bench's result at the cell the ``BENCH_*`` variables set, on ``device``."""
    from ..pipeline.engine import CellSegmentationPipeline, PipelineOptions
    from .common import card

    batch = int(os.environ.get("BENCH_BATCH", "128"))
    iters = int(os.environ.get("BENCH_ITERS", "10"))
    chunk = int(os.environ.get("BENCH_CHUNK", "4"))
    size = int(os.environ.get("BENCH_SIZE", "512"))
    max_det = int(os.environ.get("BENCH_MAX_DET", "16"))
    sam_model = os.environ.get("BENCH_SAM", "facebook/sam-vit-base")
    quant = os.environ.get("BENCH_QUANT", "none")

    opts = PipelineOptions(batch_size=batch, max_det=max_det, metric_crop=128, quant=quant)
    pipe = CellSegmentationPipeline(sam_model_type=sam_model, options=opts, device=device)
    imgs = bench_frames(batch, size, np.random.default_rng(0))
    dev_imgs = torch.from_numpy(imgs).to(device)

    def sync():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    def step():
        if chunk > 1:
            return pipe.fused_call_chunked(dev_imgs.expand(chunk, *dev_imgs.shape))
        return pipe.fused_call(dev_imgs)

    for _ in range(3):  # the first call builds the stages; two more settle
        pipe.fused_call(dev_imgs)
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync()
    ips = batch * max(chunk, 1) * iters / (time.perf_counter() - t0)

    lat = []
    for _ in range(max(iters, 10)):
        t0 = time.perf_counter()
        pipe.fused_call(dev_imgs)
        sync()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    p50, p99 = float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99))

    label = LABELS.get(sam_model, sam_model) + (f"-{quant}" if quant != "none" else "")
    result = {
        "metric": f"end-to-end images/sec/gpu (YOLOv8n+{label}+metrics, {size}x{size})",
        "value": round(ips, 2),
        "unit": "images/sec/gpu",
        "p50_image_latency_ms": round(p50 / batch, 3),
        "p99_image_latency_ms": round(p99 / batch, 3),
        "p50_batch_latency_ms": round(p50, 2),
        "batch": batch,
    }
    if os.environ.get("BENCH_E2E"):
        result.update(_directory_leg(pipe, imgs, int(os.environ.get("BENCH_E2E_FILES", "768"))))
    result["card"] = card() if pipe.device.type == "cuda" else "cpu (no card)"
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("bench/e2e.py: no CUDA device (the bench measures the card)", file=sys.stderr)
        return 1
    print(json.dumps(run("cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
