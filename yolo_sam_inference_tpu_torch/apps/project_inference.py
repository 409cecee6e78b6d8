"""The canonical project runner on the port: project/ -> conditions/ -> batches/.

Parity with the JAX package's ``apps/project_inference.py`` (reference
``examples/example_project_inference.py``): per-condition batch merge,
per-condition CSVs + summaries, global combined CSVs, ROI gating producing
``gated_cell_metrics.csv`` globally and per condition, and a run summary.
The CSVs are the port's writers' (``reporting.py``: pandas' bytes without
pandas). Runs on the card (``--device cuda``) unless asked for the CPU.

ROI selection: ``--roi-file`` (pre-made ``roi_coordinates.json``),
``--roi x_min,x_max[,y_min,y_max]`` applied to all conditions,
``--interactive-roi`` (the browser picker, ``web/app.py``, on ``--port``) or
``--cv2-roi`` (the click-two-lines picker, ``gate/picker.py``); none gates
nothing out. ``--encoder-parallel sp|tp --parallel-devices N`` runs the
conditions on N ranks (the ROIs resolved first, here), the SAM encoder's
token rows (sp) or heads and MLP hidden (tp) split over them; rank 0 writes
the run.

Usage:
    python -m yolo_sam_inference_tpu_torch.apps.project_inference \\
        --project-dir PROJECT --output-dir OUT --roi 100,400 [--batch-size 8]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List

from .single_batch_inference import build_pipeline, launch_ranks


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Project-level YOLO+SAM cell analysis")
    p.add_argument("--project-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--yolo-model", type=str, default=None)
    p.add_argument("--sam-model", type=str, default="facebook/sam-vit-base")
    p.add_argument("--sam-checkpoint", type=str, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-det", type=int, default=24)
    p.add_argument("--num-pipelines", type=int, default=2,
                   help="accepted for reference API parity; batching replaces replicas")
    p.add_argument("--save-visualizations", action="store_true")
    p.add_argument("--hull-mode", choices=("polygon", "reference"), default="polygon",
                   help="hull measurement: exact polygon (default) or the "
                        "reference's rasterize+regionprops procedure")
    p.add_argument("--encoder-parallel", choices=("none", "tp", "sp"), default="none",
                   help="shard the SAM ViT encoder over ranks: sp = its token rows, "
                        "tp = its heads and MLP hidden")
    p.add_argument("--parallel-devices", type=int, default=0,
                   help="ranks for --encoder-parallel (0 = one a visible card)")
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="int8 = dynamic w8a8 SAM-encoder projections "
                        "(accuracy bounds: apps/quant_report.py)")
    p.add_argument("--roi-file", type=Path, default=None)
    p.add_argument("--roi", type=str, default=None,
                   help="x_min,x_max[,y_min,y_max] applied to every condition")
    p.add_argument("--interactive-roi", action="store_true",
                   help="launch the browser ROI picker")
    p.add_argument("--cv2-roi", action="store_true",
                   help="the cv2 click-two-lines picker per condition (needs a display; "
                        "on a headless host use the browser picker or --roi/--roi-file)")
    p.add_argument("--port", type=int, default=9487, help="the browser picker's port")
    p.add_argument("--log-to-mlflow", action="store_true",
                   help="track params/metrics/artifacts in MLflow (if installed)")
    p.add_argument("--experiment-name", type=str, default="yolo_sam_inference_tpu")
    p.add_argument("--profile-dir", type=Path, default=None,
                   help="write a torch.profiler chrome trace of the run to this directory, "
                        "the engine's spans (dispatch, detect, nms, ...) on it as ranges")
    args = p.parse_args(argv)
    return args


def collect_images_from_batches(condition_dir: Path) -> List[Path]:
    """All images across batch_* subdirs; order mirrors the reference's
    prefix-merge (reference ``examples/example_project_inference.py:93-111``)."""
    from ..io.images import list_image_files

    images = []
    for bd in sorted(d for d in condition_dir.iterdir() if d.is_dir()):
        images.extend(list_image_files(bd))
    # images directly under the condition dir also count
    images.extend(list_image_files(condition_dir))
    return images


def resolve_rois(args, condition_names) -> Dict[str, Dict[str, int]]:
    """Each condition's ROI from ``--roi-file``, else ``--roi``, else the
    browser picker (``--interactive-roi``), else the cv2 picker
    (``--cv2-roi``), else one that gates nothing out."""
    if args.roi_file:
        with open(args.roi_file) as f:
            return json.load(f)
    if args.roi:
        try:
            vals = [int(v) for v in args.roi.split(",")]
            if len(vals) not in (2, 4):
                raise ValueError
        except ValueError:
            raise SystemExit(
                f"error: --roi must be 'x_min,x_max' or 'x_min,x_max,y_min,y_max' "
                f"(integers), got {args.roi!r}"
            )
        roi = {"x_min": vals[0], "x_max": vals[1]}
        if len(vals) >= 4:
            roi.update({"y_min": vals[2], "y_max": vals[3]})
        else:
            roi.update({"y_min": 0, "y_max": 10**9})
        return {c: dict(roi) for c in condition_names}
    if args.interactive_roi:
        from ..web.app import get_roi_coordinates_web

        condition_dirs = [args.project_dir / c for c in condition_names]
        return get_roi_coordinates_web(condition_dirs, args.output_dir, port=args.port)
    if args.cv2_roi:
        from ..gate.picker import get_roi_coordinates

        rois = {}
        for c in condition_names:
            images = collect_images_from_batches(args.project_dir / c)
            if not images:
                raise SystemExit(f"error: no images found for condition {c!r}")
            x_min, x_max = get_roi_coordinates(images[0])
            rois[c] = {"x_min": x_min, "x_max": x_max, "y_min": 0, "y_max": 10**9}
        return rois
    return {c: {"x_min": 0, "x_max": 10**9, "y_min": 0, "y_max": 10**9}
            for c in condition_names}


def _condition_dirs(project_dir: Path) -> List[Path]:
    if not project_dir.is_dir():
        raise SystemExit(f"error: --project-dir does not exist: {project_dir}")
    condition_dirs = sorted(d for d in project_dir.iterdir() if d.is_dir())
    if not condition_dirs:
        raise SystemExit(f"no condition directories under {project_dir}")
    return condition_dirs


def main(argv=None, pipeline_kwargs=None) -> int:
    """The run; ``pipeline_kwargs`` as ``single_batch_inference.build_pipeline``
    takes it."""
    args = parse_args(argv)
    t_start = time.time()
    rois = resolve_rois(args, [d.name for d in _condition_dirs(args.project_dir)])
    if args.encoder_parallel != "none":
        launch_ranks("project_inference", args, pipeline_kwargs, rois=rois, t_start=t_start)
        return 0
    return run_rank(args, pipeline_kwargs, rois=rois, t_start=t_start)


def run_rank(args, pipeline_kwargs=None, mesh=None, rois=None, t_start=None) -> int:
    """The run on this process with the resolved ``rois``, one rank of
    ``mesh`` where one is given (the mesh's first rank writes the run and
    its profiler trace)."""
    import torch.distributed as dist

    writes = mesh is None or dist.get_rank() == mesh.first
    profiler = None
    marks = contextlib.nullcontext()
    if args.profile_dir is not None and writes:
        from torch.profiler import ProfilerActivity, profile

        from ..utils.spans import recording

        args.profile_dir.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if args.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        marks = recording()  # the engine's spans as ranges on the trace
        profiler.start()
    try:
        with marks:
            run_dir = _run(args, rois, pipeline_kwargs, mesh, t_start or time.time())
    finally:
        if profiler is not None:
            profiler.stop()
    if profiler is not None:
        trace = args.profile_dir / f"{run_dir.name}.trace.json"
        profiler.export_chrome_trace(str(trace))
        print(f"profiler trace written to {trace}")
    if writes:
        print(f"\nResults written to {run_dir}")
    return 0


def _run(args, rois, pipeline_kwargs, mesh, t_start: float) -> Path:
    """The run itself; returns its directory. Under a mesh every rank runs
    every condition, and only the mesh's first rank writes."""
    from ..gate.filter import filter_cells_by_roi, save_roi_coordinates
    from ..pipeline.engine import ParallelCellSegmentationPipeline
    from ..pipeline.results import BatchProcessingResult, initialize_timing_dict
    from ..registry.tracking import collect_run_metrics, create_summary_figures, tracked_run
    from ..reporting import print_summary, save_results_to_csv, save_run_summary, write_rows_csv

    project_dir = args.project_dir
    condition_dirs = _condition_dirs(project_dir)
    condition_names = [d.name for d in condition_dirs]

    pipeline = build_pipeline(ParallelCellSegmentationPipeline, args, pipeline_kwargs, mesh,
                              yolo_model_path=args.yolo_model,
                              num_pipelines=args.num_pipelines)
    writes = pipeline.writes
    run_dir = Path(args.output_dir) / pipeline.run_id
    if writes:
        run_dir.mkdir(parents=True, exist_ok=True)
        save_roi_coordinates(rois, run_dir / "roi_coordinates.json")
        with open(run_dir / "pipeline_parameters.json", "w") as f:
            json.dump(
                {
                    **{k: str(v) if not isinstance(v, (int, float, bool, type(None))) else v
                       for k, v in dataclasses.asdict(pipeline.options).items()},
                    "sam_model_type": pipeline.sam_model_type,
                    "run_id": pipeline.run_id,
                },
                f,
                indent=2,
            )

    all_results, all_metrics, all_timing = [], [], []
    total_timing = initialize_timing_dict()

    for cond_dir in condition_dirs:
        cond = cond_dir.name
        images = collect_images_from_batches(cond_dir)
        if not images:
            continue
        cond_out = run_dir / cond
        if writes:
            cond_out.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        batch = pipeline.process_directory(
            cond_dir, cond_out, save_visualizations=args.save_visualizations,
            image_paths=images, progress=True,
        )
        cond_runtime = time.time() - t0
        for res in batch.results:
            res.condition = cond
        for row in batch.metrics_data:
            row["condition"] = cond
        for row in batch.timing_data:
            row["condition"] = cond
        cond_run_dir = cond_out / pipeline.run_id
        if writes:
            save_results_to_csv(batch, cond_run_dir)
            save_run_summary(
                batch, cond_dir, cond_run_dir, pipeline.run_id, cond_runtime,
                summary_name="condition_summary.txt", is_condition_summary=True,
            )
        all_results.extend(batch.results)
        all_metrics.extend(batch.metrics_data)
        all_timing.extend(batch.timing_data)
        for key in total_timing:
            total_timing[key] += batch.total_timing.get(key, 0)

    combined = BatchProcessingResult(
        results=all_results,
        total_timing=total_timing,
        metrics_data=all_metrics,
        timing_data=all_timing,
    )
    if not writes:
        return run_dir
    save_results_to_csv(combined, run_dir)

    # ROI gating: the gated rows keep every column of the combined rows
    gated = None
    if all_metrics:
        gated = filter_cells_by_roi(all_metrics, rois)
        fixed = ("condition", "image_name", "cell_id")
        columns = list(dict.fromkeys(k for row in all_metrics for k in row))
        write_rows_csv(gated, fixed, run_dir / "gated_cell_metrics.csv", columns)
        for cond in condition_names:
            cond_dir_out = run_dir / cond / pipeline.run_id
            if cond_dir_out.exists():
                write_rows_csv([row for row in gated if row["condition"] == cond], fixed,
                               cond_dir_out / "gated_cell_metrics.csv", columns)

    runtime = time.time() - t_start
    save_run_summary(combined, project_dir, run_dir, pipeline.run_id, runtime)
    print_summary(combined, runtime)

    if args.log_to_mlflow:
        with tracked_run(args.experiment_name, run_name=pipeline.run_id) as tracker:
            tracker.log_params(
                {
                    "project_dir": str(project_dir),
                    "sam_model": args.sam_model,
                    "yolo_model": args.yolo_model,
                    "batch_size": args.batch_size,
                    "max_det": args.max_det,
                    "conditions": ",".join(condition_names),
                }
            )
            tracker.log_metrics(collect_run_metrics(
                combined, None if gated is None else len(gated)))
            tracker.log_run_outputs(run_dir)
            if all_metrics and tracker.enabled:
                for fig in create_summary_figures(all_metrics, run_dir / "figures"):
                    tracker.log_artifact(fig)
    return run_dir


if __name__ == "__main__":
    raise SystemExit(main())
