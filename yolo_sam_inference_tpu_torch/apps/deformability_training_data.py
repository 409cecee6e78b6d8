"""Build a deformability-classification training set from gated metrics.

Parity with the JAX package's ``apps/deformability_training_data.py``:
``deformability`` cut into quantile bins as ``pd.qcut(..., 5,
duplicates="drop")`` cuts it, into ``very_low/low/medium/high/
very_high_deformability`` directories; each cell cropped with 2x bbox
expansion and the row / col swap; the crops written as PNG by the port's
writer (the same pixels the JAX tool writes through PIL); ``metadata.csv``
by ``reporting.write_rows_csv``. No pandas.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..reporting import write_rows_csv
from ..utils.logger import setup_logger
from .plot_scatter import find_original_image, load_project_data

logger = setup_logger(__name__)

GROUP_NAMES = [
    "very_low_deformability",
    "low_deformability",
    "medium_deformability",
    "high_deformability",
    "very_high_deformability",
]


def crop_cell(image, row, expansion: float = 0.5):
    """2x bbox expansion crop; min_x / max_x are ROWS (regionprops order)."""
    h, w = image.shape[:2]
    r0, r1 = int(row["min_x"]), int(row["max_x"])
    c0, c1 = int(row["min_y"]), int(row["max_y"])
    rh, rw = r1 - r0, c1 - c0
    r0 = max(0, int(r0 - rh * expansion))
    r1 = min(h, int(r1 + rh * expansion))
    c0 = max(0, int(c0 - rw * expansion))
    c1 = min(w, int(c1 + rw * expansion))
    if r1 <= r0 or c1 <= c0:
        return None
    return image[r0:r1, c0:c1]


def quantile_groups(values: np.ndarray, labels: List[str]) -> List[Optional[str]]:
    """Each value's label as ``pd.qcut(values, len(labels), labels=labels,
    duplicates="drop")`` gives it (None outside every bin): edges at the
    linear percentiles (a quantile not exact in binary nudged up, as pandas
    does), repeated edges dropped, bins closed on the right and the lowest
    edge included."""
    q = len(labels)
    quantiles = np.linspace(0, 1, q + 1)
    np.putmask(quantiles, q * quantiles != np.arange(q + 1), np.nextafter(quantiles, 1))
    edges = np.percentile(values, quantiles * 100.0, method="linear")
    unique = np.unique(edges)
    if len(unique) < len(edges) and len(edges) != 2:
        edges = unique
    if len(labels) != len(edges) - 1:
        raise ValueError("Bin labels must be one fewer than the number of bin edges")
    ids = np.searchsorted(edges, values, side="left")
    ids[values == edges[0]] = 1
    return [labels[i - 1] if 0 < i < len(edges) else None for i in ids]


def create_training_data(project_path: Path, output_dir: Path, num_bins: int = 5,
                         max_cells_per_bin: Optional[int] = None) -> List[Dict[str, Any]]:
    """Crop cells into quantile-group directories; returns the metadata rows."""
    from ..io.images import load_image, save_image

    rows = [r for r in load_project_data(project_path)
            if not (isinstance(r["deformability"], float) and math.isnan(r["deformability"]))]
    labels = GROUP_NAMES[:num_bins]
    groups = quantile_groups(np.array([r["deformability"] for r in rows], dtype=float), labels)

    output_dir = Path(output_dir)
    for g in labels:
        (output_dir / g).mkdir(parents=True, exist_ok=True)

    records = []
    counts = {g: 0 for g in labels}
    image_cache: Dict[Path, Any] = {}
    for row, group in zip(rows, groups):
        if group is None:
            continue
        if max_cells_per_bin and counts[group] >= max_cells_per_bin:
            continue
        src = find_original_image(Path(row["__csv_dir"]), str(row["image_name"]))
        if src is None:
            continue
        if src not in image_cache:
            try:
                image_cache[src] = load_image(src)
            except (OSError, ValueError):
                image_cache[src] = None
        img = image_cache[src]
        if img is None:
            continue
        crop = crop_cell(img, row)
        if crop is None or crop.size == 0:
            continue
        name = f"{Path(str(row['image_name'])).stem}_cell{int(row['cell_id'])}.png"
        out_path = output_dir / group / name
        save_image(out_path, crop)
        counts[group] += 1
        records.append({
            "file": str(out_path.relative_to(output_dir)),
            "group": group,
            "deformability": float(row["deformability"]),
            "area": row.get("area"),
            "condition": row.get("condition"),
            "image_name": row.get("image_name"),
            "cell_id": row.get("cell_id"),
        })
    write_rows_csv(records, (), output_dir / "metadata.csv")
    logger.info("Training data: %s", counts)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Deformability training-set builder")
    p.add_argument("--project-path", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--bins", type=int, default=5)
    p.add_argument("--max-cells-per-bin", type=int, default=None)
    args = p.parse_args(argv)
    create_training_data(args.project_path, args.output_dir, args.bins, args.max_cells_per_bin)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
