"""Result containers, schema-compatible with the reference dataclasses
(reference ``pipeline.py:31-45``). A copy of the JAX package's
``pipeline/results.py``, which the port may not import. Runners attach ``.condition`` dynamically
(reference ``examples/example_project_inference.py:132-133``), so the field
exists here explicitly with a default."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ProcessingResult:
    image_path: str
    cell_metrics: List[Dict[str, Any]]
    num_cells: int
    timing: Dict[str, float]
    condition: Optional[str] = None


@dataclass
class BatchProcessingResult:
    results: List[ProcessingResult]
    total_timing: Dict[str, float]
    metrics_data: List[Dict[str, Any]]
    timing_data: List[Dict[str, Any]]


def initialize_timing_dict() -> Dict[str, float]:
    """Run-level timing accumulator (reference ``pipeline.py:271-284``)."""
    return {
        "image_load": 0.0,
        "yolo_detection": 0.0,
        "sam_preprocess": 0.0,
        "sam_inference_total": 0.0,
        "sam_postprocess_total": 0.0,
        "metrics_total": 0.0,
        "visualization": 0.0,
        "total_time": 0.0,
        "total_cells": 0,
    }


def collect_metrics_data(metrics_data, result: ProcessingResult) -> None:
    """Append per-cell metric rows (reference ``pipeline.py:294-306``)."""
    from pathlib import Path

    for cell_idx, metrics in enumerate(result.cell_metrics):
        row = {"image_name": Path(result.image_path).name, "cell_id": cell_idx, **metrics}
        if result.condition is not None:
            row["condition"] = result.condition
        metrics_data.append(row)


def collect_timing_data(timing_data, result: ProcessingResult) -> None:
    """Append a per-image timing row with ``*_ms`` columns
    (reference ``pipeline.py:307-317``)."""
    from pathlib import Path

    timing_data.append(
        {
            "image_name": Path(result.image_path).name,
            "cells_processed": result.timing["cells_processed"],
            **{
                f"{k}_ms": v * 1000
                for k, v in result.timing.items()
                if k != "cells_processed"
            },
        }
    )


def update_total_timing(total_timing: Dict[str, float], timing: Dict[str, float]) -> None:
    """Accumulate per-image timings into the run totals
    (reference ``pipeline.py:319-329``)."""
    for key in total_timing:
        if key == "total_cells":
            total_timing[key] += timing["cells_processed"]
        elif key in timing:
            total_timing[key] += timing[key]
