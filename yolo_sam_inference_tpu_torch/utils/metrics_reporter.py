"""Summary statistics + per-cell detail reporting.

Capability parity with reference ``utils/metrics_reporter.py`` (whose three
functions were each defined twice with the second shadowing the first,
``:7-141`` — we implement each once). Metrics are grouped into basic / shape /
brightness families for the summary logs. A copy of the JAX package's
``utils/metrics_reporter.py``, which the port may not import.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from .logger import setup_logger

logger = setup_logger(__name__)

METRIC_GROUPS: Dict[str, Sequence[str]] = {
    "basic": ("area", "perimeter", "convex_hull_area", "convex_hull_perimeter"),
    "shape": ("deformability", "circularity", "area_ratio", "aspect_ratio"),
    "brightness": ("mean_brightness", "brightness_std"),
}


def calculate_summary_statistics(cell_metrics: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Mean/std/min/max per metric over a list of per-cell metric dicts."""
    if not cell_metrics:
        return {}
    summary: Dict[str, Dict[str, float]] = {}
    keys = [k for k, v in cell_metrics[0].items() if isinstance(v, (int, float, np.floating, np.integer))]
    for key in keys:
        values = np.asarray(
            [m[key] for m in cell_metrics if key in m], dtype=np.float64
        )
        if values.size == 0:
            continue
        summary[key] = {
            "mean": float(values.mean()),
            "std": float(values.std()),
            "min": float(values.min()),
            "max": float(values.max()),
        }
    return summary


def report_summary_statistics(cell_metrics: List[Dict[str, Any]]) -> None:
    """Log grouped mean ± std summaries."""
    summary = calculate_summary_statistics(cell_metrics)
    if not summary:
        logger.info("No cells to summarize.")
        return
    logger.info("Summary statistics over %d cells:", len(cell_metrics))
    for group, keys in METRIC_GROUPS.items():
        present = [k for k in keys if k in summary]
        if not present:
            continue
        logger.info("  [%s]", group)
        for k in present:
            s = summary[k]
            logger.info("    %s: %.4f ± %.4f", k, s["mean"], s["std"])


def report_cell_details(cell_metrics: List[Dict[str, Any]], max_cells: int = 20) -> None:
    """Log per-cell detail lines (truncated at ``max_cells``)."""
    for i, m in enumerate(cell_metrics[:max_cells]):
        logger.info(
            "  cell %d: area=%s deformability=%.4f circularity=%.4f brightness=%.1f",
            i,
            m.get("area"),
            m.get("deformability", float("nan")),
            m.get("circularity", float("nan")),
            m.get("mean_brightness", float("nan")),
        )
    if len(cell_metrics) > max_cells:
        logger.info("  ... and %d more cells", len(cell_metrics) - max_cells)
