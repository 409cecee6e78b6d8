"""TIFF output helpers with the reference's normalization semantics.

API parity with reference ``utils/image_utils.py``:
* ``save_optimized_tiff`` (reference ``:8-70``): dtype normalization to uint8,
  CHW->HWC fixup, zlib compression, 256x256 tiles, JSON metadata;
* ``save_mask_as_tiff`` (reference ``:72-104``): binary -> uint8*255, zlib
  level 1, 512x512 tiles.

Backed by our own TIFF codec (``io/tiff.py``) instead of tifffile. A copy of
the JAX package's ``utils/image_utils.py``, which the port may not import; the
metadata string stays the JAX package's, so both write the same bytes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..io.tiff import write_tiff


def _normalize_to_uint8(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype == np.uint8:
        return img
    if img.dtype == np.bool_:
        return img.astype(np.uint8) * 255
    if img.dtype == np.uint16:
        return (img / 257.0).astype(np.uint8)
    img = img.astype(np.float64)
    vmax = img.max() if img.size else 0.0
    vmin = img.min() if img.size else 0.0
    if vmax > vmin:
        img = (img - vmin) / (vmax - vmin) * 255.0
    return img.astype(np.uint8)


def save_optimized_tiff(
    image: np.ndarray,
    path,
    compression: str = "zlib",
    compression_level: int = 6,
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Save an image as a compressed, tiled TIFF (256x256 tiles)."""
    img = np.asarray(image)
    # CHW -> HWC fixup (reference utils/image_utils.py:45-47)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[0] < img.shape[2]:
        img = np.moveaxis(img, 0, -1)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    img = _normalize_to_uint8(img)
    write_tiff(
        path,
        img,
        compression=compression,
        compression_level=compression_level,
        tile=(256, 256),
        metadata=metadata or {"software": "yolo_sam_inference_tpu"},
    )


def save_mask_as_tiff(mask: np.ndarray, path) -> None:
    """Save a binary mask as a fast (zlib level 1) tiled TIFF."""
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m.squeeze()
    m = (m.astype(bool)).astype(np.uint8) * 255
    write_tiff(path, m, compression="zlib", compression_level=1, tile=(512, 512))


__all__ = ["save_optimized_tiff", "save_mask_as_tiff"]
