"""ctypes binding for the native PNG decoder (``native/png_decode.cc``).

The decoder covers the PNG forms microscopy frames use (8-bit gray, RGB and
RGBA, not interlaced): one zlib inflate, in-place unfilter, an optional
collapse of replicated-RGB pixels to one channel, straight into the caller's
numpy buffer. :func:`decode_png` returns None for any other form, and the
caller decides what to do with it (``io/images.py``).

The port reads ``native/png_decode.cc`` and never writes under ``native/``:
at first use, g++ builds the source into ``build/png_decode/<hash>/`` beside
the package (a directory ``.gitignore`` lists), keyed by a hash of the source
and the flags, as ``ops/_build.py`` does for the CUDA kernels. A failed
build raises :class:`NativeBuildError` with the compiler's output; no other
decoder takes its place.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "png_decode.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "png_decode"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz",)

_COLLAPSED = 1  # png_decode8's return code: gray written to the first w * h bytes
_BUILD_LOCK = threading.Lock()  # the loader's decode threads all reach the first build


class NativeBuildError(RuntimeError):
    """The native PNG decoder could not be built or loaded."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libpng_decode.so"


def library() -> ctypes.CDLL:
    """The loaded decoder, built on first use (once, whichever thread asks)."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise NativeBuildError(f"cannot run g++ to build the PNG decoder: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(f"building the PNG decoder failed ({' '.join(cmd)}):\n"
                                   f"{proc.stderr.strip()}")
        os.replace(tmp, out)  # atomic: another process never loads a partial file
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise NativeBuildError(f"cannot load the PNG decoder {out}: {e}") from e
    lib.png_probe.restype = ctypes.c_int32
    lib.png_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [
        ctypes.POINTER(ctypes.c_int32)] * 3
    lib.png_decode8.restype = ctypes.c_int32
    lib.png_decode8.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
    return lib


def decode_png(data: bytes, collapse: bool = False) -> Optional[np.ndarray]:
    """Decode PNG bytes to uint8 (H, W) for gray sources or (H, W, 3) for
    colour ones (alpha dropped); with ``collapse=True`` also (H, W) for RGB
    sources whose pixels all have R == G == B. None where the bytes are not
    a PNG form the decoder takes, or do not decode."""
    lib = library()
    w, h, ch = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.png_probe(data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)) != 0:
        return None
    out = np.empty(h.value * w.value * ch.value, dtype=np.uint8)
    rc = lib.png_decode8(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         1 if (collapse and ch.value == 3) else 0)
    if rc == _COLLAPSED:
        return out[: h.value * w.value].reshape(h.value, w.value)
    if rc != 0:
        return None
    if ch.value == 1:
        return out.reshape(h.value, w.value)
    return out.reshape(h.value, w.value, ch.value)
