"""Flat-folder inference runner on the port.

Parity with the JAX package's ``apps/single_batch_inference.py`` (reference
``examples/single_batch_inference.py``): process every image in a directory,
write ``cell_metrics.csv``, ``processing_times.csv`` and ``run_summary.txt``
(and, when asked, the visualisations) under ``{output-dir}/{run_id}/``, and
print summary statistics. Runs on the card (``--device cuda``) unless asked
for the CPU. Weights come from ``--yolo-model`` (an ultralytics state dict;
``--run-id`` fetches it from an MLflow run) and ``--sam-checkpoint`` (HF
``SamModel`` or MobileSAM; ``.safetensors``, ``.bin`` or ``.pt``); a model
given no file draws random weights (seed 0). ``--encoder-parallel sp|tp
--parallel-devices N`` starts N ranks (``parallel/launch.py``: NCCL with a
card each, else gloo, the ranks sharing the cards), each running the
pipeline with the SAM encoder's token rows (sp) or its heads and MLP hidden
(tp) split over the ranks; rank 0 writes the outputs.

Usage:
    python -m yolo_sam_inference_tpu_torch.apps.single_batch_inference \
        --input-dir IMGS --output-dir OUT [--yolo-model best.pt]
        [--sam-model facebook/sam-vit-base] [--sam-checkpoint model.safetensors]
        [--batch-size 8] [--max-det 24] [--hull-mode reference] [--quant int8]
        [--encoder-parallel sp|tp --parallel-devices 2] [--save-visualizations]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run YOLO+SAM cell analysis on a folder")
    p.add_argument("--input-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--yolo-model", type=str, default=None,
                   help="YOLO checkpoint path (state dict .pt)")
    p.add_argument("--sam-model", type=str, default="facebook/sam-vit-base",
                   help="SAM variant (reference default for this runner was vit-huge)")
    p.add_argument("--sam-checkpoint", type=str, default=None)
    p.add_argument("--experiment-id", type=str, default=None,
                   help="MLflow experiment id (optional)")
    p.add_argument("--run-id", type=str, default=None, help="MLflow run id (optional)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-det", type=int, default=24)
    p.add_argument("--save-visualizations", action="store_true")
    p.add_argument("--hull-mode", choices=("polygon", "reference"), default="polygon",
                   help="hull measurement: exact polygon (default) or the "
                        "reference's rasterize+regionprops procedure")
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="int8 = dynamic w8a8 SAM-encoder projections")
    p.add_argument("--encoder-parallel", choices=("none", "tp", "sp"), default="none",
                   help="shard the SAM ViT encoder over ranks: sp = its token rows, "
                        "tp = its heads and MLP hidden")
    p.add_argument("--parallel-devices", type=int, default=0,
                   help="ranks for --encoder-parallel (0 = one a visible card)")
    return p.parse_args(argv)


def launch_ranks(app: str, args, pipeline_kwargs=None, **job) -> None:
    """``--encoder-parallel sp|tp``: ``--parallel-devices`` ranks (0 = one a
    visible card) through ``parallel.launch.run_ranks``, each running
    ``apps.<app>.run_rank`` on a (dp=1, sp=N) or (dp=1, tp=N) mesh (the
    ``"app"`` job of ``parallel/workers.py``). A failed rank raises here."""
    import torch

    from ..parallel.launch import run_ranks
    from ..parallel.workers import run_jobs

    n = args.parallel_devices or (torch.cuda.device_count() if args.device == "cuda" else 0)
    if n < 1:
        raise SystemExit(f"error: --encoder-parallel {args.encoder_parallel} on device "
                         f"{args.device!r} needs --parallel-devices N")
    run_ranks(run_jobs, n, ([{"kind": "app", "app": app, "args": args,
                              "pipeline_kwargs": pipeline_kwargs,
                              "mesh": {"encoder_parallel": args.encoder_parallel, "devices": n},
                              **job}],))


def build_pipeline(cls, args, pipeline_kwargs=None, mesh=None, **kwargs):
    """``cls`` (the engine or its thread-replica wrapper) from the runner's
    arguments. ``pipeline_kwargs`` adds keyword arguments for the engine
    (configs, seed, ...), its ``"options"`` a dict of ``PipelineOptions``
    fields over the arguments' (a library caller's knob; the ranks of
    ``--encoder-parallel`` get it too)."""
    from ..pipeline.engine import PipelineOptions

    extra = dict(pipeline_kwargs or {})
    opts = PipelineOptions(batch_size=args.batch_size, max_det=args.max_det,
                           hull_mode=args.hull_mode, quant=args.quant,
                           encoder_parallel=args.encoder_parallel)
    opts = dataclasses.replace(opts, **extra.pop("options", {}))
    return cls(sam_model_type=args.sam_model, sam_checkpoint=args.sam_checkpoint,
               device=args.device, options=opts, mesh=mesh, **kwargs, **extra)


def main(argv=None, pipeline_kwargs=None) -> int:
    args = parse_args(argv)
    if not args.input_dir.is_dir():
        print(f"error: --input-dir does not exist: {args.input_dir}")
        return 2
    if args.encoder_parallel != "none":
        launch_ranks("single_batch_inference", args, pipeline_kwargs)
        return 0
    return run_rank(args, pipeline_kwargs)


def run_rank(args, pipeline_kwargs=None, mesh=None) -> int:
    """The run on this process, one rank of ``mesh`` where one is given
    (the mesh's first rank writes the outputs)."""
    from ..pipeline.engine import CellSegmentationPipeline
    from ..reporting import print_summary, save_results_to_csv, save_run_summary
    from ..utils.metrics_reporter import report_summary_statistics
    from ..utils.model_loader import load_model_from_mlflow

    yolo_path = args.yolo_model
    if yolo_path is None and args.run_id:
        yolo_path = load_model_from_mlflow(args.experiment_id or "", args.run_id)

    pipeline = build_pipeline(CellSegmentationPipeline, args, pipeline_kwargs, mesh,
                              yolo_model_path=yolo_path)

    t0 = time.time()
    batch = pipeline.process_directory(
        args.input_dir, args.output_dir, save_visualizations=args.save_visualizations
    )
    runtime = time.time() - t0
    if not pipeline.writes:
        return 0

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
