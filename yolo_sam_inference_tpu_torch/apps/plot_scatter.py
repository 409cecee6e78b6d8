"""Interactive deformability scatter plot as one self-contained HTML file.

Parity with the JAX package's ``apps/plot_scatter.py``: every condition's
``gated_cell_metrics.csv`` under a run directory, x = ``convex_hull_area``
against y = ``deformability`` coloured by condition, each condition's 2-D
Gaussian-KDE density mapped to point alpha in [0.2, 0.8], a base64 PNG crop
of the cell on hover (2x bbox expansion with the row / col swap),
click-to-hide legend entries, vanilla canvas JS (no Bokeh).

No pandas: the CSVs are read by the ``csv`` module into row dicts, each
column typed as pandas types it (int, float or str; an NA field is NaN) and
each float read as pandas' C parser reads it (``reporting.read_csv_rows``).
The crops are PNGs of the port's writer; a crop wider than ``max_size`` is
shrunk by PIL's ``thumbnail`` where PIL imports (else it has no hover image).
"""

from __future__ import annotations

import argparse
import base64
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..reporting import read_csv_rows
from ..utils.logger import setup_logger

logger = setup_logger(__name__)

PALETTE = [
    "#4269d0", "#efb118", "#ff725c", "#6cc5b0", "#3ca951",
    "#ff8ab7", "#a463f2", "#97bbf5", "#9c6b4e", "#9498a0", "#e45756",
]

Row = Dict[str, Any]


def _key(value) -> Any:
    """A value as a duplicate-finding key: every NaN the same."""
    return "\0nan" if isinstance(value, float) and math.isnan(value) else value


def load_project_data(project_path: Path) -> List[Row]:
    """Every ``gated_cell_metrics.csv`` under the run directory, in sorted
    path order, each row with its ``condition`` (the CSV's folder where the
    file has none) and ``__csv_dir``, concatenated as pandas (>= 3) does: a
    column some file lacks is NaN there, and an int column that is missing
    from a file, or float in one, becomes float; exact duplicate rows (the
    global CSV repeats the per-condition ones) dropped, the first kept."""
    project_path = Path(project_path)
    tables = []
    for path in sorted(project_path.rglob("gated_cell_metrics.csv")):
        kinds, rows = read_csv_rows(path)
        if "condition" not in kinds:
            kinds["condition"] = "str"
            for row in rows:
                row["condition"] = path.parent.name
        kinds["__csv_dir"] = "str"
        for row in rows:
            row["__csv_dir"] = str(path.parent)
        tables.append((kinds, rows))
    if not tables:
        raise FileNotFoundError(f"no gated_cell_metrics.csv under {project_path}")
    columns = list(dict.fromkeys(c for kinds, _ in tables for c in kinds))
    as_float = {c for c in columns
                if all(kinds.get(c, "float") in ("int", "float") for kinds, _ in tables)
                and any(kinds.get(c) != "int" for kinds, _ in tables)}
    keyed = [c for c in columns if c != "__csv_dir"]
    seen, out = set(), []
    for _, rows in tables:
        for row in rows:
            full = {c: (float(row[c]) if c in as_float else row[c]) if c in row else math.nan
                    for c in columns}
            key = tuple(_key(full[c]) for c in keyed)
            if key not in seen:
                seen.add(key)
                out.append(full)
    return out


def find_original_image(csv_dir: Path, image_name: str) -> Optional[Path]:
    """The run's saved original, ``1_original_images/{stem}_original.tiff``."""
    stem = Path(image_name).stem
    for base in (csv_dir, csv_dir.parent):
        cand = base / "1_original_images" / f"{stem}_original.tiff"
        if cand.exists():
            return cand
    hits = list(csv_dir.parent.rglob(f"{stem}_original.tiff"))
    return hits[0] if hits else None


def crop_cell_base64(image_path: Path, row: Row, max_size: int = 200) -> Optional[str]:
    """Base64 PNG crop of one cell (2x bbox expansion; the metric bbox is in
    row / col order, so min_x / max_x are rows)."""
    from ..io.images import _PILImage, load_image
    from ..io.png import png_bytes

    try:
        img = load_image(image_path)
    except (OSError, ValueError):
        return None
    h, w = img.shape[:2]
    r0, r1 = int(row["min_x"]), int(row["max_x"])
    c0, c1 = int(row["min_y"]), int(row["max_y"])
    rh, rw_ = r1 - r0, c1 - c0
    r0 = max(0, r0 - rh // 2)
    r1 = min(h, r1 + rh // 2)
    c0 = max(0, c0 - rw_ // 2)
    c1 = min(w, c1 + rw_ // 2)
    if r1 <= r0 or c1 <= c0:
        return None
    crop = img[r0:r1, c0:c1]
    if max(crop.shape[:2]) > max_size:
        if _PILImage is None:
            return None
        pil = _PILImage.fromarray(crop)
        pil.thumbnail((max_size, max_size))
        crop = np.asarray(pil)
    return base64.b64encode(png_bytes(crop)).decode("ascii")


def kde_alpha(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Per-point alpha from the 2-D Gaussian KDE density, scaled to
    [0.2, 0.8]; 0.6 for fewer than 3 points or a singular KDE."""
    from scipy.stats import gaussian_kde

    if len(x) < 3:
        return np.full(len(x), 0.6)
    try:
        kde = gaussian_kde(np.vstack([x, y]))
        d = kde(np.vstack([x, y]))
        lo, hi = d.min(), d.max()
        if hi > lo:
            return 0.2 + 0.6 * (d - lo) / (hi - lo)
    except np.linalg.LinAlgError:
        pass
    return np.full(len(x), 0.6)


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Deformability scatter</title><style>
 body { font-family: sans-serif; margin: 1em; background: #fff; }
 #legend span { cursor: pointer; margin-right: 1em; user-select: none; }
 #legend .off { opacity: 0.3; text-decoration: line-through; }
 #tip { position: absolute; display: none; background: #fff; border: 1px solid #999;
        padding: 6px; font-size: 12px; pointer-events: none; box-shadow: 2px 2px 6px #0003; }
 #tip img { display: block; max-width: 200px; margin-top: 4px; }
</style></head><body>
<h2>Cell deformability vs convex hull area</h2>
<div id="legend"></div>
<canvas id="c" width="1000" height="640" style="border:1px solid #ccc"></canvas>
<div id="tip"></div>
<script>
const DATA = __DATA__;
const canvas = document.getElementById('c'), ctx = canvas.getContext('2d');
const tip = document.getElementById('tip');
const M = {l: 70, r: 20, t: 20, b: 50};
const hidden = new Set();
function extents() {
  let xs = [], ys = [];
  for (const d of DATA) if (!hidden.has(d.condition)) { xs.push(d.x); ys.push(d.y); }
  if (!xs.length) return [0, 1, 0, 1];
  const pad = a => { const lo = Math.min(...a), hi = Math.max(...a), p = (hi-lo)*0.05 || 1;
                     return [lo-p, hi+p]; };
  return [...pad(xs), ...pad(ys)];
}
let sx, sy, ex;
function draw() {
  ex = extents();
  const [x0, x1, y0, y1] = ex;
  sx = v => M.l + (v-x0)/(x1-x0) * (canvas.width-M.l-M.r);
  sy = v => canvas.height-M.b - (v-y0)/(y1-y0) * (canvas.height-M.t-M.b);
  ctx.clearRect(0,0,canvas.width,canvas.height);
  ctx.strokeStyle = '#999'; ctx.fillStyle = '#333'; ctx.font = '12px sans-serif';
  ctx.strokeRect(M.l, M.t, canvas.width-M.l-M.r, canvas.height-M.t-M.b);
  for (let i = 0; i <= 5; i++) {
    const xv = x0 + (x1-x0)*i/5, yv = y0 + (y1-y0)*i/5;
    ctx.fillText(xv.toFixed(0), sx(xv)-12, canvas.height-M.b+18);
    ctx.fillText(yv.toFixed(3), 8, sy(yv)+4);
  }
  ctx.fillText('convex_hull_area', canvas.width/2-40, canvas.height-12);
  ctx.save(); ctx.translate(14, canvas.height/2+40); ctx.rotate(-Math.PI/2);
  ctx.fillText('deformability', 0, 0); ctx.restore();
  for (const d of DATA) {
    if (hidden.has(d.condition)) continue;
    ctx.globalAlpha = d.a;
    ctx.fillStyle = d.color;
    ctx.beginPath(); ctx.arc(sx(d.x), sy(d.y), 4, 0, 6.3); ctx.fill();
  }
  ctx.globalAlpha = 1;
}
function legend() {
  const conds = [...new Set(DATA.map(d => d.condition))];
  const el = document.getElementById('legend');
  el.innerHTML = '';
  for (const c of conds) {
    const s = document.createElement('span');
    const color = DATA.find(d => d.condition === c).color;
    s.innerHTML = `<b style="color:${color}">&#9679;</b> ${c}`;
    s.onclick = () => { hidden.has(c) ? hidden.delete(c) : hidden.add(c);
                        s.classList.toggle('off'); draw(); };
    el.appendChild(s);
  }
}
canvas.addEventListener('mousemove', e => {
  const r = canvas.getBoundingClientRect();
  const mx = e.clientX - r.left, my = e.clientY - r.top;
  let best = null, bd = 100;
  for (const d of DATA) {
    if (hidden.has(d.condition)) continue;
    const dx = sx(d.x)-mx, dy = sy(d.y)-my, dist = dx*dx+dy*dy;
    if (dist < bd) { bd = dist; best = d; }
  }
  if (best) {
    tip.style.display = 'block';
    tip.style.left = (e.pageX+12) + 'px'; tip.style.top = (e.pageY+12) + 'px';
    tip.innerHTML = `<b>${best.condition}</b> ${best.image}<br>` +
      `hull_area=${best.x.toFixed(0)} deformability=${best.y.toFixed(4)}` +
      (best.img ? `<img src="data:image/png;base64,${best.img}">` : '');
  } else tip.style.display = 'none';
});
legend(); draw();
</script></body></html>"""


def create_scatter_plot(project_path: Path, output_path: Optional[Path] = None,
                        max_points_per_condition: int = 2000,
                        embed_images: bool = True) -> Path:
    """Build ``scatter_plot.html`` from a run's gated metrics. A condition
    with more points than ``max_points_per_condition`` is sampled as pandas'
    ``sample(n, random_state=0)`` samples it."""
    project_path = Path(project_path)
    rows = load_project_data(project_path)
    conditions = sorted({row["condition"] for row in rows})
    points: List[Dict] = []
    for i, cond in enumerate(conditions):
        sub = [row for row in rows if row["condition"] == cond]
        if len(sub) > max_points_per_condition:
            pick = np.random.RandomState(0).choice(len(sub), size=max_points_per_condition,
                                                   replace=False)
            sub = [sub[j] for j in pick]
        alphas = kde_alpha(np.array([r["convex_hull_area"] for r in sub], dtype=float),
                           np.array([r["deformability"] for r in sub], dtype=float))
        for row, a in zip(sub, alphas):
            img_b64 = None
            if embed_images and "image_name" in row:
                src = find_original_image(Path(row["__csv_dir"]), str(row["image_name"]))
                if src is not None:
                    img_b64 = crop_cell_base64(src, row)
            points.append({
                "condition": cond,
                "x": float(row["convex_hull_area"]),
                "y": float(row["deformability"]),
                "a": float(a),
                "color": PALETTE[i % len(PALETTE)],
                "image": str(row.get("image_name", "")),
                "img": img_b64,
            })
    html = _HTML.replace("__DATA__", json.dumps(points))
    out = Path(output_path) if output_path else project_path / "scatter_plot.html"
    out.write_text(html)
    logger.info("Wrote %s (%d points, %d conditions)", out, len(points), len(conditions))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Interactive deformability scatter plot")
    p.add_argument("--project-path", type=Path, required=True,
                   help="run directory containing gated_cell_metrics.csv files")
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--no-images", action="store_true", help="skip hover image crops")
    args = p.parse_args(argv)
    create_scatter_plot(args.project_path, args.output, embed_images=not args.no_images)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
