"""MLflow experiment tracking hooks (import-gated).

A copy of the JAX package's ``registry/tracking.py`` (which the port may not
import), its summary figures drawn from lists of row dicts instead of a
pandas frame. Capability parity with the reference's opt-in tracking
(``examples/mlflow_example_project_inference.py``): run params
(``:762-782``), per-stage timing metrics (``:905-907``), per-condition cell
counts including gated (``:909-916``), artifacts (CSVs, roi json, summaries
— ``:918-937``), auto-generated summary figures (``:608-721``), and FAILED
status on exception (``:956-959``). Without mlflow (the card's machine has
none) tracking is a logged warning and nothing else; without matplotlib no
figure is drawn.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def _mlflow():
    try:
        import mlflow  # type: ignore

        return mlflow
    except ImportError:
        return None


@contextlib.contextmanager
def tracked_run(experiment_name: str = "yolo_sam_inference_tpu",
                run_name: Optional[str] = None, enabled: bool = True):
    """Context manager around an MLflow run; no-op when mlflow is absent.

    Marks the run FAILED when the body raises (reference ``:956-959``).
    """
    mlflow = _mlflow() if enabled else None
    if mlflow is None:
        if enabled:
            logger.warning("mlflow not installed; tracking disabled")
        yield _NullTracker()
        return
    mlflow.set_experiment(experiment_name)
    with mlflow.start_run(run_name=run_name):
        tracker = _MlflowTracker(mlflow)
        try:
            yield tracker
        except Exception:
            mlflow.end_run(status="FAILED")
            raise


class _NullTracker:
    enabled = False

    def log_params(self, params: Dict[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: Dict[str, float]) -> None:
        pass

    def log_artifact(self, path) -> None:
        pass

    def log_run_outputs(self, run_dir: Path) -> None:
        pass


class _MlflowTracker:
    enabled = True

    def __init__(self, mlflow):
        self._mlflow = mlflow

    def log_params(self, params: Dict[str, Any]) -> None:
        self._mlflow.log_params({k: str(v)[:250] for k, v in params.items()})

    def log_metrics(self, metrics: Dict[str, float]) -> None:
        self._mlflow.log_metrics(
            {k: float(v) for k, v in metrics.items() if v is not None}
        )

    def log_artifact(self, path) -> None:
        """With the reference's Windows<->WSL path fallback semantics
        (``safe_log_artifact :442-470``) reduced to a robust existence check."""
        path = Path(path)
        if path.exists():
            self._mlflow.log_artifact(str(path))
        else:
            logger.warning("artifact missing, not logged: %s", path)

    def log_run_outputs(self, run_dir: Path) -> None:
        """CSVs + summaries + roi json from a run directory (``:918-937``)."""
        run_dir = Path(run_dir)
        for name in (
            "cell_metrics.csv",
            "gated_cell_metrics.csv",
            "processing_times.csv",
            "run_summary.txt",
            "roi_coordinates.json",
        ):
            p = run_dir / name
            if p.exists():
                self.log_artifact(p)


def create_summary_figures(rows: List[Dict[str, Any]], output_dir: Path) -> List[Path]:
    """Auto-generated matplotlib summary figures of metric rows (reference
    ``create_and_log_summary_figures :608-721``): cell-area histogram,
    per-condition count bars, area-vs-circularity scatter. Returns paths;
    none without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        logger.warning("matplotlib not installed; no summary figures")
        return []
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    columns = {k for row in rows for k in row}
    paths = []

    def save(fig, name: str) -> None:
        p = output_dir / name
        fig.savefig(p, dpi=100, bbox_inches="tight")
        plt.close(fig)
        paths.append(p)

    if "area" in columns:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist([row.get("area", float("nan")) for row in rows], bins=50)
        ax.set_xlabel("cell area (px)")
        ax.set_ylabel("count")
        ax.set_title("Cell area distribution")
        save(fig, "area_histogram.png")

    if "condition" in columns:
        counts: Dict[Any, int] = {}
        for row in rows:
            if row.get("condition") is not None:
                counts[row["condition"]] = counts.get(row["condition"], 0) + 1
        names = sorted(counts)  # groupby's order
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar([str(n) for n in names], [counts[n] for n in names])
        ax.set_ylabel("cells")
        ax.set_title("Cells per condition")
        save(fig, "condition_counts.png")

    if {"area", "circularity"} <= columns:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.scatter([row.get("area", float("nan")) for row in rows],
                   [row.get("circularity", float("nan")) for row in rows], s=4, alpha=0.4)
        ax.set_xlabel("area")
        ax.set_ylabel("circularity")
        ax.set_title("Area vs circularity")
        save(fig, "area_vs_circularity.png")
    return paths


def collect_run_metrics(batch_result, gated_count: Optional[int] = None) -> Dict[str, float]:
    """Timing + count metrics from a BatchProcessingResult (``:899-916``)."""
    tt = batch_result.total_timing
    n = max(len(batch_result.results), 1)
    metrics = {
        "images_processed": len(batch_result.results),
        "total_cells": tt["total_cells"],
        "avg_cells_per_image": tt["total_cells"] / n,
        "avg_yolo_ms": tt["yolo_detection"] / n * 1000,
        "avg_sam_ms": tt["sam_inference_total"] / n * 1000,
        "avg_metrics_ms": tt["metrics_total"] / n * 1000,
    }
    if gated_count is not None:
        metrics["gated_cells"] = gated_count
    conditions: Dict[str, int] = {}
    for r in batch_result.results:
        cond = getattr(r, "condition", None) or "unknown"
        conditions[cond] = conditions.get(cond, 0) + r.num_cells
    for cond, count in conditions.items():
        metrics[f"cells_{cond}"] = count
    return metrics
