"""Side-by-side visualizations for the classical pipeline.

Counterpart of the JAX package's ``classical/viz.py``: a two-panel PNG,
"All Contours" (every post-morphology foreground pixel, red overlay) beside
"ROI Contours" (the kept components, blue overlay), the ROI rectangle in
green on both panels and a text block with the kept-contour count and the
mean deformability; and the full-frame mask PNGs (``*_mask.png``,
``*_filtered_mask.png``). The blend is numpy; the rectangle and text go
through PIL's ImageDraw where PIL imports (without PIL the rectangle is
drawn in numpy, pixel for pixel as ImageDraw draws it, and the panels carry
no text). Every PNG is written by the port's writer (``io/images.save_image``).
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..io.images import _PILImage, save_image

_RED = np.array([255, 0, 0], dtype=np.float32)
_BLUE = np.array([0, 0, 255], dtype=np.float32)
_GREEN = (0, 255, 0)
_WHITE = (255, 255, 255)


def _to_rgb(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def _overlay(rgb: np.ndarray, mask: np.ndarray, color: np.ndarray) -> np.ndarray:
    """0.7 * image + 0.3 * color under the mask, one vectorized pass."""
    out = rgb.astype(np.float32)
    m = np.asarray(mask, dtype=bool)
    out[m] = 0.7 * out[m] + 0.3 * color
    return out.astype(np.uint8)


def _rectangle(img: np.ndarray, box, color, width: int) -> None:
    """An outline ``width`` pixels wide inside the inclusive box (x0, y0,
    x1, y1), in place: what ``ImageDraw.rectangle(box, outline=color,
    width=width)`` draws."""
    x0, y0, x1, y1 = (int(v) for v in box)
    if x1 < x0 or y1 < y0:
        raise ValueError(f"rectangle {box}: x1 must be >= x0 and y1 >= y0")
    yy = np.arange(img.shape[0])[:, None]
    xx = np.arange(img.shape[1])[None, :]
    outer = (yy >= y0) & (yy <= y1) & (xx >= x0) & (xx <= x1)
    inner = (yy >= y0 + width) & (yy <= y1 - width) & (xx >= x0 + width) & (xx <= x1 - width)
    img[outer & ~inner] = color


def save_visualization(
    image: np.ndarray,
    mask: np.ndarray,
    filtered_mask: np.ndarray,
    roi: Optional[Dict[str, int]],
    vis_path: Path,
    contour_metrics: Optional[Sequence[Dict[str, Any]]] = None,
) -> None:
    """Write the two-panel overlay PNG. ``image``: (H, W) gray or (H, W, 3)
    RGB frame; ``mask``: the raw post-morphology foreground;
    ``filtered_mask``: the kept components only; ``roi``: optional dict of
    x_min / x_max / y_min / y_max pixel bounds."""
    rgb = _to_rgb(image)
    h, w = rgb.shape[:2]
    combined = np.concatenate([_overlay(rgb, mask, _RED), _overlay(rgb, filtered_mask, _BLUE)],
                              axis=1)
    x0 = roi.get("x_min", 0) if roi else 0
    x1 = roi.get("x_max", w) if roi else w
    y0 = roi.get("y_min", 0) if roi else 0
    y1 = roi.get("y_max", h) if roi else h
    boxes = [[off + x0, y0, off + min(x1, w - 1), min(y1, h - 1)] for off in (0, w)]
    if _PILImage is None:
        for box in boxes:
            _rectangle(combined, box, _GREEN, 2)
    else:
        from PIL import ImageDraw

        im = _PILImage.fromarray(combined)
        draw = ImageDraw.Draw(im)
        for box in boxes:
            draw.rectangle(box, outline=_GREEN, width=2)
        draw.text((10, 8), "All Contours", fill=_WHITE)
        draw.text((w + 10, 8), "ROI Contours", fill=_WHITE)
        if contour_metrics is not None:
            defs = [m["deformability"] for m in contour_metrics if "deformability" in m]
            avg_def = float(np.mean(defs)) if defs else 0.0
            draw.text((w + 10, 28), f"Contours: {len(contour_metrics)}", fill=_WHITE)
            draw.text((w + 10, 48), f"Avg Deformability: {avg_def:.4f}", fill=_WHITE)
        combined = np.asarray(im)
    vis_path = Path(vis_path)
    vis_path.parent.mkdir(parents=True, exist_ok=True)
    save_image(vis_path, combined)


def save_mask_pngs(mask: np.ndarray, filtered_mask: np.ndarray, out_dir: Path,
                   output_name: str) -> Tuple[Path, Path]:
    """``{name}_mask.png`` and ``{name}_filtered_mask.png``, mask * 255 uint8."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mask_path = out_dir / f"{output_name}_mask.png"
    filt_path = out_dir / f"{output_name}_filtered_mask.png"
    save_image(mask_path, np.asarray(mask, bool) * np.uint8(255))
    save_image(filt_path, np.asarray(filtered_mask, bool) * np.uint8(255))
    return mask_path, filt_path


def disambiguated_name(image_path: Path) -> str:
    """Collision-safe output stem: the batch folder's name as a prefix when
    it carries a digit, else a 6-hex md5 of the batch folder's path, so
    same-named frames of different batches never overwrite each other.

    The batch folder is the file's own directory, unless that is one of the
    runner's frame subdirectories (``cropped_roi_with_target`` /
    ``full_frames_with_target``); then it is the one above."""
    image_path = Path(image_path)
    sub = image_path.parent
    batch_dir = (sub.parent if sub.name in ("cropped_roi_with_target", "full_frames_with_target")
                 else sub)
    name = batch_dir.name
    if name and any(ch.isdigit() for ch in name):
        return f"{name}_{image_path.stem}"
    path_hash = hashlib.md5(str(batch_dir).encode()).hexdigest()[:6]
    return f"{path_hash}_{image_path.stem}"
