"""Reader and writer of the ``images.bin`` acquisition stream format.

A stream is a raw run of frames, each ``int32 rows | int32 cols | int32
cv_type | data`` with ``cv_type`` an OpenCV Mat type (depth = type & 7,
channels = (type >> 3) + 1). Counterpart of the JAX package's
``io/images_bin.py``: one scan of the headers, then a bulk decode to uint8
gray into a preallocated batch, in C++ (``native/images_bin.cc``) through
ctypes, so a stream of ~17k frames decodes with no per-frame Python work.

The port reads ``native/images_bin.cc`` and never writes under ``native/``:
at first use, g++ builds it into ``build/images_bin/<hash>/`` beside the
package, keyed by a hash of the source and the flags, as ``png_native.py``
does. A failed build raises :class:`NativeBuildError` with the compiler's
output; no other reader takes its place. The numpy reader
(:func:`scan_frames_plain`, :func:`read_frames_gray8_plain`) stays for
streams whose frames differ in shape, and as the plain version tests hold
the library against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .png_native import NativeBuildError

SOURCE = Path(__file__).resolve().parents[2] / "native" / "images_bin.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "images_bin"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_BUILD_LOCK = threading.Lock()

_CV_DEPTH_DTYPES = {
    0: np.uint8,
    1: np.int8,
    2: np.uint16,
    3: np.int16,
    4: np.int32,
    5: np.float32,
    6: np.float64,
}

Frame = Tuple[int, int, int, int]  # (data_offset, rows, cols, cv_type)


class _FrameInfo(ctypes.Structure):
    _fields_ = [
        ("data_offset", ctypes.c_int64),
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
        ("cv_type", ctypes.c_int32),
    ]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libimages_bin.so"


def library() -> ctypes.CDLL:
    """The loaded reader, built on first use (once, whichever thread asks)."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"cannot run g++ to build the images.bin reader: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(f"building the images.bin reader failed ({' '.join(cmd)}):\n"
                                   f"{proc.stderr.strip()}")
        os.replace(tmp, out)  # atomic: another process never loads a partial file
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise NativeBuildError(f"cannot load the images.bin reader {out}: {e}") from e
    lib.ibin_scan.restype = ctypes.c_int64
    lib.ibin_scan.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FrameInfo), ctypes.c_int64]
    lib.ibin_read_gray8.restype = ctypes.c_int32
    lib.ibin_read_gray8.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FrameInfo), ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                    ctypes.c_int64]
    return lib


def cv_type_info(cv_type: int) -> Tuple[np.dtype, int]:
    """(numpy dtype, channels) for an OpenCV Mat type code."""
    depth = cv_type & 7
    channels = (cv_type >> 3) + 1
    if depth not in _CV_DEPTH_DTYPES or not (1 <= channels <= 4):
        raise ValueError(f"unsupported cv_type {cv_type}")
    return np.dtype(_CV_DEPTH_DTYPES[depth]), channels


def scan_frames(path) -> List[Frame]:
    """Scan a stream -> [(data_offset, rows, cols, cv_type)], in C++."""
    path = Path(path)
    lib = library()
    n = lib.ibin_scan(str(path).encode(), None, 0)
    if n < 0:
        raise ValueError(f"corrupt images.bin stream: {path} (code {n})")
    arr = (_FrameInfo * n)()
    if lib.ibin_scan(str(path).encode(), arr, n) != n:
        raise ValueError(f"images.bin stream changed while scanned: {path}")
    return [(int(f.data_offset), int(f.rows), int(f.cols), int(f.cv_type)) for f in arr]


def scan_frames_plain(path) -> List[Frame]:
    """:func:`scan_frames` in numpy: header by header, with seeks."""
    path = Path(path)
    frames = []
    size = path.stat().st_size
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if not hdr:
                break
            if len(hdr) != 12:
                raise ValueError(f"corrupt images.bin stream: {path}")
            rows, cols, cv_type = struct.unpack("<3i", hdr)
            dtype, channels = cv_type_info(cv_type)
            nbytes = rows * cols * channels * dtype.itemsize
            off = f.tell()
            if off + nbytes > size:
                raise ValueError(f"truncated frame in {path}")
            frames.append((off, rows, cols, cv_type))
            f.seek(nbytes, 1)
    return frames


def _to_gray8(arr: np.ndarray) -> np.ndarray:
    """A frame to uint8 gray by the C++ decoder's rule: each channel
    converted (16-bit unsigned / 257; 16-bit signed clamped at 0, / 128),
    the channels summed in order and divided by their count, clipped to
    [0, 255], rounded half up."""
    a = arr.astype(np.float64)
    if arr.dtype == np.uint16:
        a = a / 257.0
    elif arr.dtype == np.int16:
        a = np.maximum(a, 0) / 128.0
    if a.ndim == 3:
        acc = a[..., 0].copy()
        for c in range(1, a.shape[2]):
            acc += a[..., c]
        a = acc / a.shape[2]
    return (np.clip(a, 0, 255) + 0.5).astype(np.uint8)


def read_frames_gray8(path, frames: Optional[List[Frame]] = None) -> np.ndarray:
    """Decode all (or the given) frames to a (N, rows, cols) uint8 batch: in
    C++ where the frames share a shape, else frame by frame in numpy."""
    path = Path(path)
    if frames is None:
        frames = scan_frames(path)
    if not frames:
        return np.zeros((0, 0, 0), dtype=np.uint8)
    rows, cols = frames[0][1], frames[0][2]
    if any(f[1] != rows or f[2] != cols for f in frames):
        return read_frames_gray8_plain(path, frames)
    arr = (_FrameInfo * len(frames))()
    for i, (off, r, c, t) in enumerate(frames):
        arr[i].data_offset, arr[i].rows, arr[i].cols, arr[i].cv_type = off, r, c, t
    out = np.empty((len(frames), rows, cols), dtype=np.uint8)
    rc = library().ibin_read_gray8(str(path).encode(), arr, len(frames),
                                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows, cols)
    if rc != 0:
        raise ValueError(f"native decode failed for {path} (code {rc})")
    return out


def read_frames_gray8_plain(path, frames: Optional[List[Frame]] = None) -> np.ndarray:
    """:func:`read_frames_gray8` in numpy; frames of any shapes (stacked only
    where they share one)."""
    path = Path(path)
    if frames is None:
        frames = scan_frames_plain(path)
    if not frames:
        return np.zeros((0, 0, 0), dtype=np.uint8)
    out = []
    with open(path, "rb") as f:
        for off, r, c, t in frames:
            dtype, channels = cv_type_info(t)
            f.seek(off)
            raw = np.frombuffer(f.read(r * c * channels * dtype.itemsize), dtype=dtype)
            out.append(_to_gray8(raw.reshape(r, c) if channels == 1 else
                                 raw.reshape(r, c, channels)))
    return np.stack(out)


def iter_frame_batches(path, batch_size: int = 64) -> Iterator[np.ndarray]:
    """Stream an images.bin in uint8 batches of ``batch_size`` frames; the
    whole stream is never in memory at once."""
    frames = scan_frames(path)
    for i in range(0, len(frames), batch_size):
        yield read_frames_gray8(path, frames[i:i + batch_size])


_DEPTHS = {np.dtype(np.uint8): 0, np.dtype(np.int8): 1, np.dtype(np.uint16): 2,
           np.dtype(np.int16): 3, np.dtype(np.int32): 4, np.dtype(np.float32): 5,
           np.dtype(np.float64): 6}


def write_images_bin(path, images: List[np.ndarray]) -> None:
    """Write frames in the stream format (for tests and interop)."""
    with open(path, "wb") as f:
        for img in images:
            img = np.ascontiguousarray(img)
            channels = 1 if img.ndim == 2 else img.shape[2]
            cv_type = _DEPTHS[img.dtype] + ((channels - 1) << 3)
            f.write(struct.pack("<3i", img.shape[0], img.shape[1], cv_type))
            f.write(img.tobytes())


__all__ = ["NativeBuildError", "cv_type_info", "iter_frame_batches", "read_frames_gray8",
           "read_frames_gray8_plain", "scan_frames", "scan_frames_plain", "write_images_bin"]
