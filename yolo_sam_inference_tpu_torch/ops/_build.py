"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` in its own process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with :mod:`ctypes`. The library goes to
``build/kernels/<hash>/`` beside the package (a directory that ``.gitignore``
lists), keyed by a hash of the sources and flags, so an edit rebuilds and an
unchanged tree loads what an earlier process built. ``ptxas.log`` beside it
keeps what ``-Xptxas -v`` said of every kernel (registers, shared memory,
spills).

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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: (argtypes). Each returns cudaGetLastError() as an int.
_SIGNATURES = {
    # a, a2, w, bias, ln_scale, ln_bias, scratch, r1, r2, out, m, n, k, eps, gelu, stream
    "ysi_gemm_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # qkv, rel_h, rel_w, out, b, s, heads, hd, window (16), stream
    "ysi_window_attn_relpos": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, rel_h, rel_w, out, b, heads, nq, s, row0, hd, q token / image
    # strides, k and v token / image strides, window (0: the whole grid), stream
    "ysi_flash_attn_relpos": (_P,) * 6 + (_I,) * 11 + (_P,),
    # keys, pe, kq, vq, wq, bq, wo, bo, ln_s, ln_b, wk, bk, wv, bv, qn,
    # out_keys, out_kp, out_vp, part, n, t, tq, tq2, k_share, scale, eps, do_i2t, stream
    "ysi_keys_stream": (_P,) * 19 + (_I, _I, _I, _I, _I, _F, _F, _I, _P),
    # part, out, n, tiles, tq2, stream
    "ysi_t2i_combine": (_P, _P, _I, _I, _I, _P),
    # qp, kp, vp, out, n, tq, t, k_share, stream
    "ysi_t2i_attend": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, h, ln_scale, ln_bias, xq, xs, m, c, eps, stream
    "ysi_ln_quant": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P),
    # mode, a, bt, a_scale, w_scale, bias, r1, r2, out, m, n, k, chunk, stream
    "ysi_gemm_int8": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # hf, hq, hs, m, n, chunk, stream
    "ysi_gelu_quant": (_P, _P, _P, _I, _I, _I, _P),
    # grid, r0, c0, r0 stride, c0 stride, out, n, gs, c, wg, stream
    "ysi_window_crop": (_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P),
    # masks, dirs, out, any, ext, part_s, part_k, n, h, w, d, chunks a slice, stream
    "ysi_hull_support": (_P,) * 7 + (_I,) * 5 + (_P,),
    # qkv, pad, bias, out, b, h, w, heads, ws, stream
    "ysi_tinyvit_attn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, wqkv_t, wproj_t, table, ln_scale, ln_bias, bqkv, bproj, out, b, h, w, c, ws, eps, stream
    "ysi_tinyvit_block": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    # bf16, x, w1, b1, wd, bd, w3, b3, out, b, h, w, c, e, co, stream
    "ysi_patch_merge": (_I,) + (_P,) * 8 + (_I,) * 6 + (_P,),
    # residual, bf16, x, w1, b1, wd, bd, w3, b3, out, b, h, w, c, e, co, stream
    "ysi_mbconv_s1": (_I, _I) + (_P,) * 8 + (_I,) * 6 + (_P,),
    # x, wd, bd, ln_scale, ln_shift, y, ln, b, h, w, c, eps, stream
    "ysi_dw_conv3x3": (_P,) * 7 + (_I,) * 4 + (_F, _P),
    # x, w, bias, out, b, h, w, ci, xs, co, wrows, wld, k, stride, act, stream
    "ysi_conv2d_act": (_P,) * 4 + (_I,) * 11 + (_P,),
    # x, r, y, out, scale, bias, rows, c, eps, stream
    "ysi_layer_norm": (_P,) * 6 + (_I, _I, _F, _P),
    # qkv, out, b, s, heads, hd, window (0: the whole grid), pool, token stride, stream
    "ysi_hiera_attention": (_P, _P) + (_I,) * 7 + (_P,),
    # x, fp32, 4 strides, vec, b, c, cin, ys, wy, ky, xs, wx, kx, nh, nw, oy, ox, out, oh,
    # ow, sub, div, pad, ty, tx, vw, rh, stream
    "ysi_resample": (_P, _I) + (_L,) * 4 + (_I,) * 4 + (_P, _P, _I, _P, _P) + (_I,) * 5
                    + (_P, _I, _I, _P, _P, _F) + (_I,) * 4 + (_P,),
}
# Run once after loading (shared-memory attributes of the kernels).
_INITS = ("ysi_gemm_init", "ysi_gemm_int8_init", "ysi_window_attn_init",
          "ysi_flash_attn_relpos_init", "ysi_decoder_init", "ysi_tinyvit_attn_init",
          "ysi_tinyvit_block_init", "ysi_tinyvit_conv_init", "ysi_mbconv_s1_init",
          "ysi_conv2d_act_init", "ysi_hull_support_init", "ysi_hiera_attn_init",
          "ysi_resample_init")


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


def _run_all(cmds) -> list:
    """Run the commands in parallel; raise with the failures' output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]  # waits for every process
    bad = [(c, p.returncode, log) for c, p, log in zip(cmds, procs, logs) if p.returncode]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"({rc}) {' '.join(c)}\n{log}" for c, rc, log in bad))
    return logs


def build() -> tuple:
    """Compile the kernels if the hashed library is missing: one nvcc per
    source, all at once, then one link.

    Returns (path, seconds spent compiling; 0.0 when it was already built).
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    nvcc = _nvcc()
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in srcs]
    t0 = time.perf_counter()
    logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(srcs, objs)])
    tmp = out.with_suffix(f".{tag}.tmp")
    _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *map(str, objs)]])
    (out.parent / "ptxas.log").write_text("".join(logs))
    for o in objs:
        o.unlink()
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out, time.perf_counter() - t0


def ptxas_report() -> str:
    """The ``-Xptxas -v`` lines of the current build (registers, spills)."""
    log = library_path().parent / "ptxas.log"
    return log.read_text() if log.exists() else ""


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
