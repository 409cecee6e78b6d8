"""LayerNorm-fused projections and the row LayerNorm (kernels K1, K4, K5).

Counterpart of ``yolo_sam_inference_tpu/ops/fused_ln.py``. Two kernels carry
these functions on the card:

* ``gemm_bf16`` (``csrc/gemm_bf16.cu``): a bf16 GEMM with an optional
  LayerNorm prologue and a bias / GELU / residual epilogue. It carries
  :func:`fused_ln_matmul` (K1: LN1 + qkv), :func:`fused_ln_mlp` (K4: the
  block tail, two launches) and the attention output projection.
  Its source note says what bounds it and what the design does about it.
* ``layer_norm`` (Triton, below): K5, a row LayerNorm with fp32 statistics
  and an optional residual add, which covers the JAX package's
  ``fused_ln`` (:761) and ``fused_add_ln`` (:56). It is a row reduction plus
  an elementwise pass, so it is memory bound: one read of x (and the
  residual) and one write per output, one row per program. It takes any C
  (256 on the neck and decoder, 64 in the mask head).

Dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the kernel (or raises). There is no
fallback. Each kernel wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ._build import BUILD_ROOT, check, kernels


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"unsupported device {t.device}: expected cpu or cuda")
    return False


# ------------------------------------------------------------------ plain math


def layer_norm_plain(x, scale, bias, eps: float, residual=None):
    """LayerNorm over the last axis with fp32 statistics, output in x's dtype.
    With ``residual``: returns (y, LN(y)) for y = x + residual."""
    y = x if residual is None else x + residual
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    d = yf - mean
    var = (d * d).mean(-1, keepdim=True)
    ln = (d * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)
    return ln if residual is None else (y, ln)


def gemm_plain(a, w, bias=None, a2=None, ln=None, gelu=False, r1=None, r2=None):
    """What ``gemm_bf16`` computes, in fp32 (result in a's dtype).
    ``ln`` is (scale, bias, eps) for the LayerNorm prologue."""
    x = a if a2 is None else a + a2
    if ln is not None:
        x = layer_norm_plain(x, ln[0], ln[1], ln[2])
    y = x.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = F.gelu(y)  # exact erf form, as torch.nn.GELU() in SAM
    if r1 is not None:
        res = r1 if r2 is None else r1 + r2
        y = res.float() + y
    return y.to(a.dtype)


# ------------------------------------------------------------------ kernels


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _derived(t: torch.Tensor, tag: str, make):
    """``make(t)``, kept on ``t`` and made again only when t's storage, dtype,
    device or shape change. For weights, which are read-only at inference: a
    launch then casts or transposes nothing."""
    key = (t.data_ptr(), t.dtype, t.device, tuple(t.shape))
    cache = t.__dict__.setdefault("_kernel_forms", {})
    hit = cache.get(tag)
    if hit is None or hit[0] != key:
        hit = cache[tag] = (key, make(t.detach()))
    return hit[1]


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The fp32 copy the kernels take for biases and LayerNorm parameters."""
    if t is None:
        return None
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return _derived(t, "f32", lambda v: v.to(torch.float32).contiguous())


def _check_bf16(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: needs a contiguous bf16 tensor on {device}, got "
                         f"{t.dtype} contiguous={t.is_contiguous()} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer is not 16-byte aligned")


def gemm_bf16(a, w, bias=None, a2=None, ln=None, gelu=False, r1=None, r2=None):
    """``epilogue(LN(a (+ a2)) @ w)`` on 2-D (M, K) rows; see :func:`gemm_plain`.

    CPU tensors take :func:`gemm_plain`; CUDA tensors launch the kernel of
    ``csrc/gemm_bf16.cu`` (bf16 operands, K and N multiples of 8).
    """
    if _on_cpu(a):
        return gemm_plain(a, w, bias, a2, ln, gelu, r1, r2)
    m, k = a.shape
    n = w.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"gemm_bf16: K={k} and N={n} must be multiples of 8")
    dev = a.device
    _check_bf16("a", a, (m, k), dev)
    _check_bf16("w", w, (k, n), dev)
    for name, t in (("a2", a2), ("r1", r1), ("r2", r2)):
        if t is not None:
            _check_bf16(name, t, (m, k) if name == "a2" else (m, n), dev)
    if r2 is not None and r1 is None:
        raise ValueError("gemm_bf16: r2 needs r1")
    bias32 = _f32(bias)
    scale32, shift32 = (_f32(ln[0]), _f32(ln[1])) if ln is not None else (None, None)
    eps = float(ln[2]) if ln is not None else 0.0
    # per-row LN statistics (mean, rstd), written by the kernel's first launch
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev) if ln is not None else None
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = kernels().ysi_gemm_bf16(
        _ptr(a), _ptr(a2), _ptr(w), _ptr(bias32), _ptr(scale32), _ptr(shift32), _ptr(stats),
        _ptr(r1), _ptr(r2), _ptr(out), m, n, k, eps, int(bool(gelu)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "gemm_bf16")
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


@functools.lru_cache(maxsize=1)
def _triton_layer_norm():
    """Compile-on-first-use Triton kernel (triton exists only on the card's host).
    Its cache goes beside the CUDA build, inside the checkout."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_ROOT.parent / "triton"))
    import triton
    import triton.language as tl

    @triton.jit
    def kernel(x_ptr, r_ptr, y_ptr, out_ptr, w_ptr, b_ptr, n_cols, eps,
               HAS_RES: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < n_cols
        off = row * n_cols + cols
        x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        if HAS_RES:
            x = x + tl.load(r_ptr + off, mask=mask, other=0.0).to(tl.float32)
            y = x.to(y_ptr.dtype.element_ty)
            tl.store(y_ptr + off, y, mask=mask)
            x = y.to(tl.float32)  # normalise the stored (rounded) sum
        mean = tl.sum(x, axis=0) / n_cols
        d = tl.where(mask, x - mean, 0.0)
        var = tl.sum(d * d, axis=0) / n_cols
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0)
        b = tl.load(b_ptr + cols, mask=mask, other=0.0)
        tl.store(out_ptr + off, (d * rstd * w + b).to(out_ptr.dtype.element_ty), mask=mask)

    return kernel, triton.next_power_of_2


def layer_norm(x, scale, bias, eps: float = 1e-6, residual=None):
    """Row LayerNorm over the last axis (K5); with ``residual`` returns
    ``(x + residual, LayerNorm(x + residual))`` like ``fused_add_ln``."""
    if _on_cpu(x):
        return layer_norm_plain(x, scale, bias, eps, residual)
    kernel, next_pow2 = _triton_layer_norm()
    c = x.shape[-1]
    x2 = x.contiguous()
    r2 = residual.contiguous() if residual is not None else None
    if r2 is not None and (r2.shape != x2.shape or r2.dtype != x2.dtype):
        raise ValueError("layer_norm: residual must match x in shape and dtype")
    out = torch.empty_like(x2)
    y = torch.empty_like(x2) if r2 is not None else out
    rows = x2.numel() // c
    block = next_pow2(c)
    kernel[(rows,)](
        x2, r2 if r2 is not None else x2, y, out, _f32(scale), _f32(bias), c, float(eps),
        HAS_RES=r2 is not None, BLOCK=block, num_warps=4 if block >= 1024 else 1,
    )
    layer_norm.launches += 1
    return out if r2 is None else (y, out)


layer_norm.launches = 0


# ------------------------------------------------------------ the fused blocks


def fused_ln_matmul(x, scale, bias, w, b, eps: float = 1e-6, gemm=gemm_bf16):
    """``LayerNorm(x) @ w + b`` (K1: LN1 + qkv). x (..., C) -> (..., O).
    ``gemm=gemm_plain`` runs the plain version on any device (the oracle)."""
    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1])
    out = gemm(a.contiguous(), w, b, ln=(scale, bias, eps))
    return out.reshape(*lead, w.shape[1])


def fused_ln_mlp(x, h, scale, bias, w1, b1, w2, b2, eps: float = 1e-6, gemm=gemm_bf16):
    """Block tail (K4): ``y = x + h; y + mlp2(GELU(mlp1(LayerNorm(y))))``.

    Two GEMM launches; the (rows, hidden) activation passes through device
    memory between them (the TPU kernel keeps it in VMEM).
    """
    c = x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    h2 = h.reshape(-1, c).contiguous()
    hid = gemm(x2, w1, b1, a2=h2, ln=(scale, bias, eps), gelu=True)
    out = gemm(hid, w2, b2, r1=x2, r2=h2)
    return out.reshape(x.shape)


def linear(x, w, b, gemm=gemm_bf16):
    """``x @ w + b`` through the GEMM kernel (the attention projection)."""
    lead = x.shape[:-1]
    out = gemm(x.reshape(-1, x.shape[-1]).contiguous(), w, b)
    return out.reshape(*lead, w.shape[1])


__all__ = [
    "fused_ln_matmul", "fused_ln_mlp", "gemm_bf16", "gemm_plain", "layer_norm",
    "layer_norm_plain", "linear",
]
