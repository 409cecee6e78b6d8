"""libdeflate-backed zlib-stream compression for big host-side payloads.

The visualization path writes up to seven tiled-zlib TIFFs per frame
(reference ``pipeline.py:331-438`` layout); ``zlib.compress`` of one
512x512 RGB frame costs ~52 ms on the 1-vCPU bench host and dominates
viz-enabled runs. libdeflate produces the SAME wire format (an RFC-1950
zlib stream, decodable by ``zlib.decompress`` / tifffile / any TIFF
reader) ~2.4x faster and ~19% smaller at level 6 (measured on-host).
Falls back to the stdlib when the shared library is absent. A copy of the
JAX package's ``io/deflate.py``, which the port may not import.
"""

from __future__ import annotations

import ctypes
import threading
import zlib

_LIB_NAMES = ("libdeflate.so.0", "libdeflate.so", "libdeflate.dylib")
_lib = None
_lib_failed = False
_tls = threading.local()


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    for name in _LIB_NAMES:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.libdeflate_alloc_compressor.restype = ctypes.c_void_p
        lib.libdeflate_alloc_compressor.argtypes = [ctypes.c_int]
        lib.libdeflate_zlib_compress_bound.restype = ctypes.c_size_t
        lib.libdeflate_zlib_compress_bound.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t
        ]
        lib.libdeflate_zlib_compress.restype = ctypes.c_size_t
        lib.libdeflate_zlib_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        _lib = lib
        return _lib
    _lib_failed = True
    return None


def compress(data: bytes, level: int = 6) -> bytes:
    """zlib-stream compress via libdeflate when available (stdlib fallback).

    The output always decodes with ``zlib.decompress`` — only speed and
    (slightly) ratio differ from the stdlib. ``level`` follows zlib's 1-9
    scale (libdeflate accepts 1-12; values pass through clamped).
    """
    lib = _load()
    if lib is None or not data:
        return zlib.compress(data, level)
    lvl = max(1, min(int(level), 12))
    comps = getattr(_tls, "comps", None)
    if comps is None:
        comps = _tls.comps = {}
    comp = comps.get(lvl)
    if comp is None:
        comp = lib.libdeflate_alloc_compressor(lvl)
        if not comp:
            return zlib.compress(data, level)
        comps[lvl] = comp
    bound = lib.libdeflate_zlib_compress_bound(comp, len(data))
    buf = ctypes.create_string_buffer(bound)
    n = lib.libdeflate_zlib_compress(comp, data, len(data), buf, bound)
    if n == 0:  # can't fit (never for a real bound) — stdlib fallback
        return zlib.compress(data, level)
    return buf.raw[:n]
