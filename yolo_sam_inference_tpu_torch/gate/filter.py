"""ROI gating filter + roi_coordinates.json persistence.

A copy of the JAX package's ``gate/filter.py`` (which the port may not
import) on lists of row dicts instead of pandas frames, as ``reporting.py``
writes them. Semantics parity with reference
``examples/example_project_inference.py:270-315``: the gate keeps cells whose
horizontal bbox center — computed as ``center_y = (min_y + max_y) / 2``
because the metric bbox keys carry the regionprops row/col convention
(``min_y`` is the min COLUMN) — lies within the ROI's ``[x_min, x_max]``.
This deliberate axis swap (commented in the reference at ``:298``) is
load-bearing for downstream CSV consumers, so we reproduce it exactly.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List

from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def _value(row: Dict[str, Any], key: str) -> float:
    """A row's number, NaN where it has none (as pandas fills the gap)."""
    v = row.get(key)
    return math.nan if v is None else v


def filter_cells_by_roi(
    rows: List[Dict[str, Any]], roi_coordinates: Dict[str, Dict[str, int]]
) -> List[Dict[str, Any]]:
    """The cell metric rows inside each condition's ROI, condition by
    condition in the ROIs' order, each condition's rows in their order. A
    row whose ``min_y`` or ``max_y`` is missing or NaN is outside every ROI."""
    columns = {k for row in rows for k in row}
    missing = [c for c in ("condition", "min_y", "max_y") if c not in columns]
    if missing:
        raise ValueError(f"Missing required columns in metrics rows: {missing}")

    gated: List[Dict[str, Any]] = []
    for condition, roi in roi_coordinates.items():
        cond_rows = [r for r in rows if r.get("condition") == condition]
        if not cond_rows:
            logger.warning("No data found for condition: %s", condition)
            continue
        keep = [r for r in cond_rows
                if roi["x_min"] <= (_value(r, "min_y") + _value(r, "max_y")) / 2 <= roi["x_max"]]
        logger.info("Gated %d/%d cells for condition %s", len(keep), len(cond_rows), condition)
        gated.extend(keep)
    return gated


def save_roi_coordinates(rois: Dict[str, Dict[str, int]], path) -> None:
    """Persist per-condition ROIs (reference ``web/app.py:129-131``)."""
    with open(path, "w") as f:
        json.dump(rois, f, indent=2)


def load_roi_coordinates(path) -> Dict[str, Dict[str, int]]:
    with open(path) as f:
        return json.load(f)
