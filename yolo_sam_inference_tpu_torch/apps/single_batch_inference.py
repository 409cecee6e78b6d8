"""Flat-folder inference runner on the port.

Parity with the JAX package's ``apps/single_batch_inference.py`` (reference
``examples/single_batch_inference.py``): process every image in a directory,
write ``cell_metrics.csv``, ``processing_times.csv`` and ``run_summary.txt``
(and, when asked, the visualisations) under ``{output-dir}/{run_id}/``, and
print summary statistics. Runs on the card (``--device cuda``) unless asked
for the CPU. Weights are random (seed 0); the arguments the port cannot
honour yet raise, naming the ``ROADMAP.md`` item that ports them.

Usage:
    python -m yolo_sam_inference_tpu_torch.apps.single_batch_inference \
        --input-dir IMGS --output-dir OUT [--sam-model facebook/sam-vit-base]
        [--batch-size 8] [--max-det 24] [--quant int8] [--save-visualizations]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

# argument -> (the value it may keep, the ROADMAP.md item that ports it)
NOT_PORTED = {
    "yolo_model": (None, "Queue 1 item 2, checkpoint loading"),
    "sam_checkpoint": (None, "Queue 1 item 2, checkpoint loading"),
    "experiment_id": (None, "Queue 1 item 2, checkpoint loading (the MLflow lookup)"),
    "run_id": (None, "Queue 1 item 2, checkpoint loading (the MLflow lookup)"),
    "hull_mode": ("polygon", "Queue 1 item 5, hull_mode='reference'"),
    "encoder_parallel": ("none", "Queue 1 items 4 and 6, the parallel encoders"),
    "parallel_devices": (0, "Queue 1 items 4 and 6, the parallel encoders"),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run YOLO+SAM cell analysis on a folder")
    p.add_argument("--input-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--yolo-model", type=str, default=None,
                   help="YOLO checkpoint path (not ported yet)")
    p.add_argument("--sam-model", type=str, default="facebook/sam-vit-base",
                   help="SAM variant (reference default for this runner was vit-huge)")
    p.add_argument("--sam-checkpoint", type=str, default=None, help="not ported yet")
    p.add_argument("--experiment-id", type=str, default=None,
                   help="MLflow experiment id (not ported yet)")
    p.add_argument("--run-id", type=str, default=None, help="MLflow run id (not ported yet)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-det", type=int, default=24)
    p.add_argument("--save-visualizations", action="store_true")
    p.add_argument("--hull-mode", choices=("polygon", "reference"), default="polygon",
                   help="hull measurement; 'reference' is not ported yet")
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="int8 = dynamic w8a8 SAM-encoder projections")
    p.add_argument("--encoder-parallel", choices=("none", "tp", "sp"), default="none",
                   help="shard the SAM ViT encoder over cards (not ported yet)")
    p.add_argument("--parallel-devices", type=int, default=0, help="not ported yet")
    args = p.parse_args(argv)
    for name, (keep, item) in NOT_PORTED.items():
        if getattr(args, name) != keep:
            p.error(f"--{name.replace('_', '-')} {getattr(args, name)} is not ported yet "
                    f"(ROADMAP.md {item})")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.input_dir.is_dir():
        print(f"error: --input-dir does not exist: {args.input_dir}")
        return 2
    from ..pipeline.engine import CellSegmentationPipeline, PipelineOptions
    from ..reporting import print_summary, save_results_to_csv, save_run_summary
    from ..utils.metrics_reporter import report_summary_statistics

    opts = PipelineOptions(batch_size=args.batch_size, max_det=args.max_det, quant=args.quant)
    pipeline = CellSegmentationPipeline(sam_model_type=args.sam_model, device=args.device,
                                        options=opts)

    t0 = time.time()
    batch = pipeline.process_directory(
        args.input_dir, args.output_dir, save_visualizations=args.save_visualizations
    )
    runtime = time.time() - t0

    run_dir = Path(args.output_dir) / pipeline.run_id
    save_results_to_csv(batch, run_dir)
    save_run_summary(batch, args.input_dir, run_dir, pipeline.run_id, runtime)
    print_summary(batch, runtime)
    all_metrics = [m for r in batch.results for m in r.cell_metrics]
    report_summary_statistics(all_metrics)
    print(f"\nResults written to {run_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
