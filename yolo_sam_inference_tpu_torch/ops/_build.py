"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The library
goes to ``build/kernels/<hash>/`` beside the package (a directory that
``.gitignore`` lists), keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree loads what an earlier process built.

Nothing happens at import: the first wrapper that launches a kernel calls
:func:`kernels`, which builds when needed. The CPU tests never reach it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (argtypes). Each returns cudaGetLastError() as an int.
_SIGNATURES = {
    # a, a2, w, bias, ln_scale, ln_bias, stats, r1, r2, out, m, n, k, eps, gelu, stream
    "ysi_gemm_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # qkv, rel_h, rel_w, out, b, s, heads, hd, window, stream
    "ysi_window_attn_relpos": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # keys, pe, kq, vq, wq, bq, wo, bo, ln_s, ln_b, wk, bk, wv, bv, qn,
    # out_keys, out_kp, out_vp, part, n, t, tq, tq2, k_share, scale, eps, do_i2t, stream
    "ysi_keys_stream": (_P,) * 19 + (_I, _I, _I, _I, _I, _F, _F, _I, _P),
    # part, out, n, tiles, tq2, stream
    "ysi_t2i_combine": (_P, _P, _I, _I, _I, _P),
    # qp, kp, vp, out, n, tq, t, k_share, stream
    "ysi_t2i_attend": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # grid, r0, c0, out, n, gs, c, wg, stream
    "ysi_window_crop": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # pts, dirs, out, n, p, d, stream
    "ysi_hull_support": (_P, _P, _P, _I, _I, _I, _P),
}
# Run once after loading (shared-memory attributes of the kernels).
_INITS = ("ysi_gemm_init", "ysi_window_attn_init", "ysi_decoder_init")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libysi_kernels.so"


def build() -> tuple:
    """Compile the kernels if the hashed library is missing.

    Returns (path, seconds spent compiling; 0.0 when it was already built).
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    for name in _INITS:
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        check(fn(), name)
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {err}")
