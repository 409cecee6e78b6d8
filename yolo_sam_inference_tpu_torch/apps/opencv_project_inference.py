"""The classical (model-free) project runner on the port, with threshold sweeps.

Parity with the JAX package's ``apps/opencv_project_inference.py``: a project
of conditions with ``*_output/{cropped_roi_with_target,
full_frames_with_target}`` batch folders (the frame cleaner's layout), a
``*background*`` frame per batch, one run per threshold of ``--thresholds``
(``"5,10,15"``) in a threshold-tagged run dir with ``pipeline_parameters.json``,
and per run ``image_summary.csv``, ``cell_metrics.csv`` and
``deformability_summary.csv``, written by ``reporting.write_rows_csv`` with
the bytes pandas writes. Runs on the card (``--device cuda``) unless asked
for the CPU.

Usage:
    python -m yolo_sam_inference_tpu_torch.apps.opencv_project_inference \\
        --project-dir PROJECT --output-dir OUT --thresholds 10,20 [--batch-size 16]
"""

from __future__ import annotations

import argparse
import math
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..classical.pipeline import ClassicalParams, ClassicalPipeline
from ..classical.viz import disambiguated_name, save_mask_pngs, save_visualization
from ..io.images import list_image_files, load_image
from ..reporting import write_rows_csv
from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def find_batch_folders(condition_dir: Path) -> List[Path]:
    """``*_output`` dirs holding curated frames, else the condition dir."""
    outs = sorted(d for d in condition_dir.glob("*_output") if d.is_dir())
    return outs or [condition_dir]


def find_frames_and_background(batch_dir: Path):
    """A batch's curated frames and its background frame (or None)."""
    for sub in ("cropped_roi_with_target", "full_frames_with_target", "."):
        d = batch_dir / sub
        if d.is_dir():
            images = list_image_files(d)
            files = [p for p in images if "background" not in p.name.lower()]
            bgs = [p for p in images if "background" in p.name.lower()]
            if files:
                return files, (bgs[0] if bgs else None)
    return [], None


def run_condition(pipeline: ClassicalPipeline, condition_dir: Path,
                  roi: Optional[Dict[str, int]], batch_size: int,
                  vis_dir: Optional[Path] = None):
    """-> (cell rows, image summary rows) of one condition. With
    ``vis_dir``, each image's side-by-side overlay and mask PNGs go there
    (names batch-disambiguated); a visualization that fails is logged, never
    fatal."""
    cell_rows, image_rows = [], []
    for batch_dir in find_batch_folders(condition_dir):
        files, bg_path = find_frames_and_background(batch_dir)
        if not files:
            continue
        background = load_image(bg_path if bg_path is not None else files[0],
                                grayscale=True).astype(np.float32)
        pipeline.preprocess_background(background, key=str(batch_dir))
        by_shape: Dict = {}  # device batches need one shape
        for p in files:
            img = load_image(p, grayscale=True)
            by_shape.setdefault(img.shape, []).append((p, img))
        for items in by_shape.values():
            for i in range(0, len(items), batch_size):
                chunk = items[i:i + batch_size]
                frames = np.stack([im for _, im in chunk])
                if vis_dir is not None:
                    results, masks, filt = pipeline.process_images(
                        frames, background_key=str(batch_dir), roi=roi, return_masks=True)
                    for j, (path, img) in enumerate(chunk):
                        name = disambiguated_name(path)
                        try:
                            save_visualization(img, masks[j], filt[j], roi,
                                               vis_dir / f"{name}_visualization.png",
                                               results[j])
                            save_mask_pngs(masks[j], filt[j], vis_dir, name)
                        except Exception as exc:  # a visualization is never fatal
                            logger.warning("visualization failed for %s: %s", path, exc)
                else:
                    results = pipeline.process_images(frames, background_key=str(batch_dir),
                                                      roi=roi)
                for (path, _), rows in zip(chunk, results):
                    for k, row in enumerate(rows):
                        cell_rows.append({"condition": condition_dir.name,
                                          "batch": batch_dir.name, "image_name": path.name,
                                          "cell_id": k, **row})
                    image_rows.append({
                        "condition": condition_dir.name, "batch": batch_dir.name,
                        "image_name": path.name, "num_cells": len(rows),
                        "mean_area": float(np.mean([r["area"] for r in rows])) if rows else 0.0,
                    })
    return cell_rows, image_rows


def _mean(values: List[float]) -> float:
    """pandas' groupby mean: a compensated (Kahan) sum over the count."""
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total / len(values)


def _std(values: List[float]) -> float:
    """pandas' groupby std (ddof 1): Welford's update; NaN for one value."""
    mean = m2 = 0.0
    for n, v in enumerate(values, start=1):
        old = mean
        mean += (v - old) / n
        m2 += (v - mean) * (v - old)
    return math.sqrt(m2 / (len(values) - 1)) if len(values) > 1 else math.nan


def deformability_summary(cells: List[Dict]) -> List[Dict]:
    """Per condition, in sorted order: num_cells, mean_area,
    mean_deformability, std_deformability (ddof 1, empty for one cell)."""
    by_cond: Dict[str, List[Dict]] = {}
    for row in cells:
        by_cond.setdefault(row["condition"], []).append(row)
    return [{"condition": cond, "num_cells": len(rows),
             "mean_area": _mean([float(r["area"]) for r in rows]),
             "mean_deformability": _mean([float(r["deformability"]) for r in rows]),
             "std_deformability": _std([float(r["deformability"]) for r in rows])}
            for cond, rows in sorted(by_cond.items())]


def run_with_threshold(project_dir: Path, output_dir: Path, threshold: float, args,
                       roi: Optional[Dict[str, int]]) -> Path:
    """One sweep point: a run dir with the parameters and the three CSVs."""
    params = ClassicalParams(
        threshold=threshold,
        dilate_iterations=args.dilate_iterations,
        erode_iterations=args.erode_iterations,
        blur_kernel=args.blur_kernel,
        blur_sigma=args.blur_sigma,
        min_area=args.min_area,
        batch_size=args.batch_size,
    )
    pipeline = ClassicalPipeline(params, device=args.device)
    run_id = f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_thresh{threshold:g}"
    run_dir = Path(output_dir) / run_id
    run_dir.mkdir(parents=True, exist_ok=True)
    pipeline.save_parameters(run_dir / "pipeline_parameters.json")

    all_cells, all_images = [], []
    for cond in sorted(d for d in Path(project_dir).iterdir() if d.is_dir()):
        t0 = time.time()
        vis_dir = (run_dir / cond.name) if args.save_visualizations else None
        cells, images = run_condition(pipeline, cond, roi, args.batch_size, vis_dir=vis_dir)
        all_cells.extend(cells)
        all_images.extend(images)
        logger.info("condition %s: %d cells / %d images (%.1fs)", cond.name, len(cells),
                    len(images), time.time() - t0)

    if all_images:
        write_rows_csv(all_images, (), run_dir / "image_summary.csv")
    if all_cells:
        write_rows_csv(all_cells, (), run_dir / "cell_metrics.csv")
        write_rows_csv(deformability_summary(all_cells), (),
                       run_dir / "deformability_summary.csv")
    print(f"threshold {threshold:g}: results in {run_dir}")
    return run_dir


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Classical project inference")
    p.add_argument("--project-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--thresholds", type=str, default="10",
                   help="comma-separated sweep, e.g. '5,10,15'")
    p.add_argument("--dilate-iterations", type=int, default=2)
    p.add_argument("--erode-iterations", type=int, default=2)
    p.add_argument("--blur-kernel", type=int, default=5)
    p.add_argument("--blur-sigma", type=float, default=0.0)
    p.add_argument("--min-area", type=float, default=50.0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--roi", type=str, default=None, help="x_min,x_max[,y_min,y_max]")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--no-save-visualizations", dest="save_visualizations",
                   action="store_false", default=True,
                   help="skip the per-image side-by-side overlays and mask PNGs written by "
                        "default (about 3 PNG encodes a frame of host CPU): pass this for "
                        "throughput runs")
    args = p.parse_args(argv)
    if not args.project_dir.is_dir():
        print(f"error: --project-dir does not exist: {args.project_dir}")
        return 2
    try:
        thresholds = [float(t) for t in args.thresholds.split(",")]
    except ValueError:
        raise SystemExit(f"error: bad --thresholds value {args.thresholds!r}")
    roi = None
    if args.roi:
        v = [int(x) for x in args.roi.split(",")]
        roi = {"x_min": v[0], "x_max": v[1]}
        if len(v) >= 4:
            roi.update({"y_min": v[2], "y_max": v[3]})
    for t in thresholds:
        run_with_threshold(args.project_dir, args.output_dir, t, args, roi)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
