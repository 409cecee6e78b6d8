"""Report generation: CSVs, run summaries, console summary.

Byte-compatible output schemas with the reference ``reporting.py``:
* ``cell_metrics.csv`` with fixed leading columns
  ``['condition', 'image_name', 'cell_id']`` (reference ``reporting.py:19-27``);
* ``processing_times.csv`` with leading
  ``['condition', 'image_name', 'cells_processed']`` (``:34-39``);
* ``run_summary.txt`` sections and ``print_summary`` console block
  (``:43-153``).

A copy of the JAX package's ``reporting.py`` (which the port may not
import), but for the CSV writer: the card's machine has no pandas, so the
``csv`` module writes the bytes ``DataFrame(rows).to_csv(index=False)`` gives.
"""

from __future__ import annotations

import csv
import math
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Sequence

from .pipeline.results import BatchProcessingResult


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column_text(values: List[Any]) -> List[str]:
    """One column as pandas writes it when it builds the column from records:
    ints alone stay ints; numbers with a float or a gap among them become
    float64 (repr, ``5`` as ``5.0``); anything else is str; a missing value or
    a NaN is an empty field."""
    present = [v for v in values if not _missing(v)]
    numbers = all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
    if present and numbers:
        if len(present) == len(values) and all(isinstance(v, int) for v in present):
            return [str(v) for v in values]
        return ["" if _missing(v) else repr(float(v)) for v in values]
    return ["" if _missing(v) else str(v) for v in values]


def _write_csv(rows: List[Dict[str, Any]], fixed: Sequence[str], path: Path) -> None:
    """``pandas.DataFrame(rows)`` with the ``fixed`` columns first, as
    ``to_csv(path, index=False)`` writes it: columns in order of first
    appearance, minimal quoting, a line feed ending each line."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    columns = [c for c in fixed if c in columns] + [c for c in columns if c not in fixed]
    cells = [_column_text([row.get(c) for row in rows]) for c in columns]
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*cells))


def save_results_to_csv(batch_result: BatchProcessingResult, output_dir: Path) -> None:
    """Save metrics and timing data to CSV files."""
    output_dir = Path(output_dir)
    if batch_result.metrics_data:
        _write_csv(batch_result.metrics_data, ("condition", "image_name", "cell_id"),
                   output_dir / "cell_metrics.csv")
    if batch_result.timing_data:
        _write_csv(batch_result.timing_data, ("condition", "image_name", "cells_processed"),
                   output_dir / "processing_times.csv")


def generate_summary_text(
    batch_result: BatchProcessingResult,
    input_dir: Path,
    output_dir: Path,
    run_id: str,
    total_runtime: float,
    is_condition_summary: bool = False,
) -> str:
    """Generate a comprehensive summary (sections mirror reference
    ``reporting.py:43-110``)."""
    num_images = max(len(batch_result.results), 1)
    tt = batch_result.total_timing

    lines = []
    if is_condition_summary:
        condition = batch_result.results[0].condition if batch_result.results else "Unknown"
        lines.append(f"Condition Summary: {condition}")
        lines.append("=" * len(lines[0]) + "\n")
    else:
        lines.append("Pipeline Run Summary")
        lines.append("==================\n")

    lines.append(f"Run ID: {run_id}")
    lines.append(f"Timestamp: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}")
    lines.append(f"Input Directory: {Path(input_dir).absolute()}")
    lines.append(f"Output Directory: {Path(output_dir).absolute()}\n")

    if not is_condition_summary:
        lines.append("Condition Breakdown")
        lines.append("==================")
        conditions = {}
        for r in batch_result.results:
            cond = getattr(r, "condition", None) or "Unknown"
            stats = conditions.setdefault(cond, {"images": 0, "cells": 0})
            stats["images"] += 1
            stats["cells"] += r.num_cells
        for cond, stats in conditions.items():
            lines.append(f"Condition: {cond}")
            lines.append(f"  Images processed: {stats['images']}")
            lines.append(f"  Cells detected: {stats['cells']}")
            lines.append(
                f"  Average cells per image: {stats['cells'] / stats['images']:.1f}\n"
            )

    lines.append("Processing Statistics")
    lines.append("====================")
    lines.append(f"Total images processed: {len(batch_result.results)}")
    lines.append(f"Total cells detected: {tt['total_cells']}")
    lines.append(f"Average cells per image: {tt['total_cells'] / num_images:.1f}\n")

    lines.append("Timing Statistics (averaged per image)")
    lines.append("===================================")
    lines.append(f"Image loading: {(tt['image_load'] / num_images) * 1000:.1f}ms")
    lines.append(f"YOLO detection: {(tt['yolo_detection'] / num_images) * 1000:.1f}ms")
    lines.append(f"SAM preprocessing: {(tt['sam_preprocess'] / num_images) * 1000:.1f}ms")
    lines.append(f"SAM inference: {(tt['sam_inference_total'] / num_images) * 1000:.1f}ms")
    lines.append(
        f"SAM postprocessing: {(tt['sam_postprocess_total'] / num_images) * 1000:.1f}ms"
    )
    lines.append(f"Metrics calculation: {(tt['metrics_total'] / num_images) * 1000:.1f}ms")
    lines.append(f"Visualization: {(tt['visualization'] / num_images) * 1000:.1f}ms\n")

    lines.append("Overall Performance")
    lines.append("==================")
    lines.append(f"Total runtime: {total_runtime:.1f}s")
    lines.append(f"Average time per image: {total_runtime / num_images:.3f}s")
    lines.append(f"Throughput: {len(batch_result.results) / max(total_runtime, 1e-9):.1f} images/s")
    if tt["total_cells"] > 0:
        lines.append(
            f"Average time per cell: {(total_runtime / tt['total_cells']) * 1000:.1f}ms"
        )
    return "\n".join(lines)


def print_summary(batch_result: BatchProcessingResult, total_runtime: float) -> None:
    """Console performance summary (reference ``reporting.py:112-153``)."""
    num_images = max(len(batch_result.results), 1)
    tt = batch_result.total_timing

    print("\n" + "=" * 80)
    print("PIPELINE PERFORMANCE SUMMARY")
    print("=" * 80)

    print("\nCondition Breakdown:")
    conditions = {}
    for r in batch_result.results:
        cond = getattr(r, "condition", None) or "Unknown"
        stats = conditions.setdefault(cond, {"images": 0, "cells": 0})
        stats["images"] += 1
        stats["cells"] += r.num_cells
    for cond, stats in conditions.items():
        print(f"\nCondition: {cond}")
        print(f"  Images processed: {stats['images']}")
        print(f"  Cells detected: {stats['cells']}")
        print(f"  Average cells per image: {stats['cells'] / stats['images']:.1f}")

    print("\nOverall Statistics:")
    print(f"Total images processed: {len(batch_result.results)}")
    print(f"Total cells detected: {tt['total_cells']}")
    print(f"Average cells per image: {tt['total_cells'] / num_images:.1f}")
    print("\nTiming Breakdown (averaged per image):")
    print(f"Image loading: {(tt['image_load'] / num_images) * 1000:.1f}ms")
    print(f"YOLO detection: {(tt['yolo_detection'] / num_images) * 1000:.1f}ms")
    print(f"SAM preprocessing: {(tt['sam_preprocess'] / num_images) * 1000:.1f}ms")
    print(f"SAM inference: {(tt['sam_inference_total'] / num_images) * 1000:.1f}ms")
    print(f"SAM postprocessing: {(tt['sam_postprocess_total'] / num_images) * 1000:.1f}ms")
    print(f"Metrics calculation: {(tt['metrics_total'] / num_images) * 1000:.1f}ms")
    print(f"Visualization: {(tt['visualization'] / num_images) * 1000:.1f}ms")
    print(f"\nTotal runtime: {total_runtime:.1f}s")
    print(f"Average time per image: {total_runtime / num_images:.3f}s")
    if tt["total_cells"] > 0:
        print(f"Average time per cell: {(total_runtime / tt['total_cells']) * 1000:.1f}ms")
    print("=" * 80)


def save_run_summary(
    batch_result: BatchProcessingResult,
    input_dir: Path,
    output_dir: Path,
    run_id: str,
    total_runtime: float,
    summary_name: str = "run_summary.txt",
    is_condition_summary: bool = False,
) -> None:
    """Write ``run_summary.txt`` (reference ``reporting.py:155-174``)."""
    text = generate_summary_text(
        batch_result, input_dir, output_dir, run_id, total_runtime, is_condition_summary
    )
    with open(Path(output_dir) / summary_name, "w") as f:
        f.write(text)
