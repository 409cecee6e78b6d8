"""Time one slice of the pipeline of one checkout, for end-to-end runs in turns.

    python yolo_sam_inference_tpu_torch/bench/slice_turns.py --tree DIR --tag NAME
        [--model facebook/sam-vit-huge] [--quant none|int8] [--frame 512]
        [--cells 40] [--max-det 16] [--batch 32] [--iters 5]

Imports ``yolo_sam_inference_tpu_torch`` from the checkout at DIR (its
kernels build into DIR/build/), so one script times two trees, or two modes
of one tree: run it in turns (A, B, B, A), each in its own process, and
compare the medians. Builds ``CellSegmentationPipeline`` (random weights from
seed 0), makes ``--batch`` synthetic gray frames with ``--cells`` cells
(``bench/common.py::cell_frames``, seed 0; this script's own checkout), runs
two warm-up batches, then ``--iters`` timed batches of ``process_batch_arrays``
(wall clock after a device synchronise, upload and fetch included). Prints
the card, then one ``[TAG] ...`` line: the median ms per batch, every
iteration's ms, and the mean ms per batch of each stage. ``--dump PATH``
writes the last batch's outputs (boxes, scores, valid, offsets, the
metrics, the mask crops) to an ``.npz`` file; ``--against PATH`` holds them
to such a file, another tree's, byte for byte, and prints one more line.
Needs one card.
``--frame 2048`` with ViT-H is config 4 (the 1024 canvas).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path


def _own_common():
    """This checkout's bench/common.py, whichever tree is being timed."""
    spec = importlib.util.spec_from_file_location("_turns_common",
                                                  Path(__file__).with_name("common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the checkout whose port to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--model", default="facebook/sam-vit-huge")
    ap.add_argument("--quant", default="none", choices=("none", "int8"))
    ap.add_argument("--frame", type=int, default=512)
    ap.add_argument("--cells", type=int, default=40)
    ap.add_argument("--max-det", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dump", help="write the last batch's outputs to this .npz file")
    ap.add_argument("--against", help="compare the last batch's outputs with this .npz file")
    args = ap.parse_args()
    common = _own_common()
    sys.path.insert(0, args.tree)

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.pipeline.engine import (
        CellSegmentationPipeline,
        PipelineOptions,
    )

    print(common.card(), flush=True)
    opts = PipelineOptions(max_det=args.max_det, quant=args.quant)
    pipe = CellSegmentationPipeline(sam_model_type=args.model, device="cuda", options=opts, seed=0)
    frames = common.cell_frames(np.random.default_rng(0), args.batch, args.frame,
                                cells=args.cells)
    for _ in range(2):
        pipe.process_batch_arrays(frames)
    per_iter, stages = [], {}
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.process_batch_arrays(frames, stages)
        per_iter.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(per_iter)
    stage_ms = {k: round(v / args.iters * 1e3, 3) for k, v in stages.items()}
    print(f"[{args.tag}] {args.model} quant {args.quant} {args.frame}x{args.frame} batch "
          f"{args.batch}: {ms:.2f} ms/batch median (iterations {[round(t, 2) for t in per_iter]}), "
          f"stages {json.dumps(stage_ms)}", flush=True)
    arrays = {f"metrics/{k}": np.asarray(v) for k, v in out["metrics"].items()}
    arrays.update({k: np.asarray(v) for k, v in out.items() if k != "metrics"})
    if args.dump:
        np.savez(args.dump, **arrays)
    if args.against:
        with np.load(args.against) as ref:
            differ = sorted(k for k in set(ref.files) | set(arrays)
                            if k not in ref.files or k not in arrays
                            or ref[k].dtype != arrays[k].dtype or ref[k].shape != arrays[k].shape
                            or ref[k].tobytes() != arrays[k].tobytes())
        print(f"[{args.tag}] outputs against {args.against}: "
              + (f"differ in {differ}" if differ else
                 f"bit for bit equal ({len(arrays)} arrays, "
                 f"{sum(a.nbytes for a in arrays.values())} bytes)"), flush=True)


if __name__ == "__main__":
    main()
