"""CLI of the images.bin classical pipeline on the port.

Parity with the JAX package's ``apps/ms_opencv_process.py``, plus
``--device`` (the card unless asked for the CPU). Writes
``deformability_results.csv`` and ``pipeline_parameters.json``.

Usage:
    python -m yolo_sam_inference_tpu_torch.apps.ms_opencv_process \\
        --project-dir PROJECT --output-dir OUT [--threshold 10] [--batch-size 64]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..classical.ms_process import MsProcessingConfig, process_project


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Process images.bin acquisition streams (classical pipeline)")
    p.add_argument("--project-dir", type=Path, required=True,
                   help="root containing batch dirs with images.bin (+ roi.csv, background)")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--threshold", type=float, default=10.0)
    p.add_argument("--min-area", type=float, default=250.0)
    p.add_argument("--max-area", type=float, default=1200.0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--no-single-inner", action="store_true",
                   help="disable the require-single-inner-contour gate")
    p.add_argument("--debug-dumps", action="store_true",
                   help="write sampled per-frame stage PNGs (original/roi/background/"
                        "processed) to <batch_dir>/debug")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if not args.project_dir.is_dir():
        print(f"error: --project-dir does not exist: {args.project_dir}")
        return 2
    cfg = MsProcessingConfig(
        threshold=args.threshold,
        min_area=args.min_area,
        max_area=args.max_area,
        batch_size=args.batch_size,
        require_single_inner=not args.no_single_inner,
        debug_dumps=args.debug_dumps,
    )
    rows = process_project(args.project_dir, args.output_dir, cfg, device=args.device)
    print(f"{len(rows)} valid cells -> {args.output_dir / 'deformability_results.csv'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
