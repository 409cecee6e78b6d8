"""Visualization outputs in the reference's 7-directory layout.

Layout parity with reference ``pipeline.py:354-362``:
  1_original_images/            {name}_original.tiff
  2_yolo_detections/            {name}_detections.tiff
  3_processed_masks/masks/      {name}_cell_{i}_mask.tiff
  3_processed_masks/overlay_images/        {name}_overlay.tiff
  3_processed_masks/convex_hull_overlay/   {name}_hull.tiff
  4_combined_visualization/     {name}_combined.tiff

Drawing uses cv2 (host-side, like the reference) where it can be imported;
the masks, overlays and combined panels are numpy and always written. TIFFs
go through the port's tiled-zlib codec. A copy of the JAX package's
``pipeline/visualize.py``, which the port may not import.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from ..utils.image_utils import save_mask_as_tiff, save_optimized_tiff

try:
    import cv2
except ImportError:  # the card's machine has no cv2
    cv2 = None

_DIRS = {
    "original": "1_original_images",
    "yolo": "2_yolo_detections",
    "masks": "3_processed_masks/masks",
    "overlay": "3_processed_masks/overlay_images",
    "hull": "3_processed_masks/convex_hull_overlay",
    "combined": "4_combined_visualization",
}


def _full_masks(mask_crops: np.ndarray, offsets: np.ndarray, valid: np.ndarray, h: int, w: int):
    cm = mask_crops.shape[-1]
    masks = []
    for k in range(valid.shape[0]):
        if not valid[k]:
            continue
        m = np.zeros((h, w), dtype=bool)
        r0, c0 = int(offsets[k, 0]), int(offsets[k, 1])
        m[r0 : r0 + cm, c0 : c0 + cm] = mask_crops[k]
        masks.append(m)
    return masks


def save_visualizations(
    image: np.ndarray,
    mask_crops: np.ndarray,
    offsets: np.ndarray,
    boxes: np.ndarray,
    valid: np.ndarray,
    cell_metrics: List[Dict[str, Any]],
    output_dir: Path,
    name: str,
) -> None:
    """Write the full visualization set for one image."""
    output_dir = Path(output_dir)
    for d in _DIRS.values():
        (output_dir / d).mkdir(parents=True, exist_ok=True)

    h, w = image.shape[:2]
    masks = _full_masks(mask_crops, offsets, valid, h, w)
    vboxes = boxes[valid.astype(bool)]

    save_optimized_tiff(image, output_dir / _DIRS["original"] / f"{name}_original.tiff")

    # YOLO detections
    det = image.copy()
    if cv2 is not None:
        for b in vboxes:
            cv2.rectangle(det, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), (255, 0, 0), 1)
    save_optimized_tiff(det, output_dir / _DIRS["yolo"] / f"{name}_detections.tiff")

    # per-cell masks + overlay
    overlay = image.astype(np.float32)
    for i, m in enumerate(masks):
        save_mask_as_tiff(m, output_dir / _DIRS["masks"] / f"{name}_cell_{i}_mask.tiff")
        overlay[m] = overlay[m] * 0.5 + np.asarray([0.0, 255.0, 0.0]) * 0.5
    overlay = overlay.astype(np.uint8)
    save_optimized_tiff(overlay, output_dir / _DIRS["overlay"] / f"{name}_overlay.tiff")

    # convex hull overlay
    hull_img = image.copy()
    if cv2 is not None:
        for m in masks:
            pts = cv2.findContours(
                m.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
            )[0]
            if pts:
                hull = cv2.convexHull(np.vstack([p.reshape(-1, 2) for p in pts]))
                cv2.polylines(hull_img, [hull], True, (0, 0, 255), 1)
    save_optimized_tiff(hull_img, output_dir / _DIRS["hull"] / f"{name}_hull.tiff")

    # combined side-by-side panel (original | detections | overlay)
    combined = np.concatenate([image, det, overlay], axis=1)
    save_optimized_tiff(
        combined, output_dir / _DIRS["combined"] / f"{name}_combined.tiff"
    )
