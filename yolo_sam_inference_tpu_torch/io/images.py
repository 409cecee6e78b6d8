"""Image loading and directory discovery.

A copy of the JAX package's ``io/images.py`` (which the port may not import),
but for its decode: PNGs go through the native decoder (``png_native.py``)
and TIFFs through the port's codec (``tiff.py``). PIL, where it can be
imported, takes only the forms those two do not (JPEG, palette or 16-bit
PNG, ...); where it cannot, such a file raises. Loading returns RGB uint8
(H, W, 3) whatever the source format, matching the reference's BGR->RGB
conversion contract.
"""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from .png_native import decode_png
from .tiff import read_tiff

try:
    from PIL import Image as _PILImage
except ImportError:  # the card's machine has no PIL
    _PILImage = None

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".tif")


def _to_scaled_uint8(arr: np.ndarray) -> np.ndarray:
    """Dtype normalization only (no channel-count changes)."""
    if arr.dtype == np.uint16:
        arr = (arr / 257.0).astype(np.uint8)  # 65535 -> 255
    elif arr.dtype == np.bool_:
        arr = arr.astype(np.uint8) * 255
    elif arr.dtype != np.uint8:
        amax = float(arr.max()) if arr.size else 1.0
        scale = 255.0 / amax if amax > 0 else 1.0
        arr = np.clip(arr * scale, 0, 255).astype(np.uint8)
    return arr


def _to_rgb_uint8(arr: np.ndarray) -> np.ndarray:
    """Normalize any decoded array to RGB uint8 (H, W, 3)."""
    arr = _to_scaled_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    elif arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    elif arr.shape[2] == 4:
        arr = arr[..., :3]
    return np.ascontiguousarray(arr)


def _decode(path: Path, collapse: bool = False) -> np.ndarray:
    suffix = path.suffix.lower()
    if suffix in (".tif", ".tiff"):
        try:
            return read_tiff(path)
        except ValueError:  # a TIFF form the codec does not read
            pass
    elif suffix == ".png":
        arr = decode_png(path.read_bytes(), collapse=collapse)
        if arr is not None:
            return arr
    if _PILImage is None:
        raise ValueError(f"{path}: not a form the port decodes without PIL (8-bit gray, RGB "
                         f"or RGBA PNG, not interlaced; the TIFFs io/tiff.py reads), and PIL "
                         f"is not installed")
    with _PILImage.open(path) as im:
        return np.asarray(im)


def load_image(path) -> np.ndarray:
    """Load an image file as RGB uint8 (H, W, 3)."""
    return _to_rgb_uint8(_decode(Path(path)))


def load_image_collapsed(path) -> np.ndarray:
    """Load for the batch loader: (H, W) uint8 when the source is
    single-channel — stored grayscale OR replicated-RGB — else (H, W, 3).

    ``load_image`` expands grayscale sources to RGB only for the loader to
    collapse them straight back for the 1-channel host->device transfer
    (pipeline/loader.py); this skips that expand/collapse round trip (one
    ``np.repeat`` + two channel compares + a copy per image — the host
    loader is the measured e2e bottleneck on a single-core host).
    """
    arr = _to_scaled_uint8(_decode(Path(path), collapse=True))
    if arr.ndim == 2:
        return np.ascontiguousarray(arr)
    if arr.ndim == 3 and arr.shape[2] == 1:
        return np.ascontiguousarray(arr[..., 0])
    if arr.ndim == 3 and arr.shape[2] >= 3:
        c0 = arr[..., 0]
        if np.array_equal(c0, arr[..., 1]) and np.array_equal(c0, arr[..., 2]):
            return np.ascontiguousarray(c0)
        return np.ascontiguousarray(arr[..., :3])
    return _to_rgb_uint8(arr)


def list_image_files(directory) -> List[Path]:
    """Sorted image files in ``directory`` (reference ``pipeline.py:265-269``)."""
    return sorted(p for p in Path(directory).glob("*")
                  if p.is_file() and p.suffix.lower() in IMAGE_EXTENSIONS)
