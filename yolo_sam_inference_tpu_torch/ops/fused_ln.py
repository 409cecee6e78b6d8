"""LayerNorm-fused projections and the row LayerNorm (kernels K1, K4, K5,
K10, K11a-c).

Counterpart of ``yolo_sam_inference_tpu/ops/fused_ln.py``. Three kernel
sources carry these functions on the card:

* ``gemm_bf16`` (``csrc/gemm_bf16.cu``): a bf16 GEMM on TMA and wgmma, after
  an optional LayerNorm pass over its A operand, with a bias / GELU /
  residual epilogue. It carries
  :func:`fused_ln_matmul` (K1: LN1 + qkv), :func:`fused_ln_mlp` (K4 and
  K10: the block tail, two launches) and the attention output projection.
  Its source note says what bounds it and what the design does about it.
* ``csrc/gemm_int8.cu``: the w8a8 functions on the int8 tensor cores,
  :func:`fused_ln_matmul_int8` (K11c), :func:`fused_ln_mlp_int8` (K11a) and
  :func:`fused_ln_mlp_tiled_int8` (K11b): a LayerNorm + row quantisation
  pass, int8 GEMMs with dequantising epilogues, and a per-chunk
  requantisation of the tail's hidden; and :func:`int8_linear`, the flat
  route's w8a8 projections (the JAX package's unfused ``int8_linear``): the
  quantisation pass without the LayerNorm, then one int8 GEMM.
* ``csrc/layer_norm.cu``: :func:`layer_norm`, K5, a row LayerNorm with fp32
  statistics and an optional residual add, which covers the JAX package's
  ``fused_ln`` (:761) and ``fused_add_ln`` (:56). It is memory bound: one
  read of x (and the residual) and one write per output; a group of lanes
  per row moves 16-byte vectors. It takes the paths' widths and no other:
  C 256 on the necks and the decoder, 64 in the mask head, 768, 1024 and
  1280 on the flat route at ViT-B, -L and -H.

Dispatch is by the tensor's device: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the kernel (or raises). There is no
fallback. Each kernel wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import quant
from ._build import check, kernels
from .quant import int_dot, quant_rows


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
    # LN(a (+ a2)) or a + a2 in bf16: written by the kernel's first launch,
    # the product's A operand
    pre = ln is not None or a2 is not None
    scratch = torch.empty((m, k), dtype=torch.bfloat16, device=dev) if pre else None
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    err = kernels().ysi_gemm_bf16(
        _ptr(a), _ptr(a2), _ptr(w), _ptr(bias32), _ptr(scale32), _ptr(shift32), _ptr(scratch),
        _ptr(r1), _ptr(r2), _ptr(out), m, n, k, eps, int(bool(gelu)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "gemm_bf16")
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


# The widths the LayerNorm kernel takes, those of the ported paths: 64 (the
# mask head's up_ln), 256 (the SAM and TinyViT necks, the decoder), 768,
# 1024 and 1280 (the flat route's residual LayerNorms at ViT-B, -L, -H).
LN_WIDTHS = (64, 256, 768, 1024, 1280)


def layer_norm(x, scale, bias, eps: float = 1e-6, residual=None):
    """Row LayerNorm over the last axis (K5); with ``residual`` returns
    ``(x + residual, LayerNorm(x + residual))`` like ``fused_add_ln`` (K11d),
    the LayerNorm of the stored bf16 sum. The two forms count their launches
    apart: ``.launches`` and ``.residual_launches``.

    The kernel (``csrc/layer_norm.cu``) takes bf16 x (and residual) with C
    one of ``LN_WIDTHS``."""
    if _on_cpu(x):
        return layer_norm_plain(x, scale, bias, eps, residual)
    c = x.shape[-1]
    if c not in LN_WIDTHS:
        raise ValueError(f"layer_norm kernel takes C in {LN_WIDTHS}, got {c}")
    x2 = x.contiguous()
    r2 = residual.contiguous() if residual is not None else None
    _check_bf16("layer_norm x", x2, x2.shape, x2.device)
    if r2 is not None:
        _check_bf16("layer_norm residual", r2, x2.shape, x2.device)
    scale32, bias32 = _f32(scale), _f32(bias)
    for name, t in (("scale", scale32), ("bias", bias32)):
        if tuple(t.shape) != (c,) or t.device != x2.device or t.data_ptr() % 16:
            raise ValueError(f"layer_norm kernel: {name} must be ({c},) on {x2.device}, "
                             f"16-byte aligned; got {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(x2)
    y = torch.empty_like(x2) if r2 is not None else None
    rows = x2.numel() // c
    if rows == 0:  # nothing to launch
        return out if r2 is None else (y, out)
    err = kernels().ysi_layer_norm(
        _ptr(x2), _ptr(r2), _ptr(y), _ptr(out), _ptr(scale32), _ptr(bias32), rows, c,
        float(eps), torch.cuda.current_stream(x2.device).cuda_stream,
    )
    check(err, "layer_norm")
    if r2 is None:
        layer_norm.launches += 1
        return out
    layer_norm.residual_launches += 1
    return y, out


layer_norm.launches = 0  # the plain form (K5)
layer_norm.residual_launches = 0  # the residual form (K11d's call sites)


# ------------------------------------------------------------ the fused blocks


def fused_ln_matmul(x, scale, bias, w, b, eps: float = 1e-6, gemm=gemm_bf16):
    """``LayerNorm(x) @ w + b`` (K1: LN1 + qkv). x (..., C) -> (..., O).
    ``gemm=gemm_plain`` runs the plain version on any device (the oracle)."""
    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1])
    out = gemm(a.contiguous(), w, b, ln=(scale, bias, eps))
    return out.reshape(*lead, w.shape[1])


def fused_ln_mlp(x, h, scale, bias, w1, b1, w2, b2, eps: float = 1e-6, gemm=gemm_bf16):
    """Block tail (K4, and K10 at the ViT-L/H widths):
    ``y = x + h; y + mlp2(GELU(mlp1(LayerNorm(y))))``.

    Two GEMM launches; the (rows, hidden) activation passes through device
    memory between them (the TPU kernel keeps it in VMEM). The JAX package's
    ``fused_ln_mlp_tiled`` (K10) computes the same function (one fp32 sum,
    one downcast) and tiles the hidden only because the ViT-L/H weights do
    not fit in VMEM, so this function carries it too.
    """
    c = x.shape[-1]
    x2 = x.reshape(-1, c).contiguous()
    h2 = h.reshape(-1, c).contiguous()
    hid = gemm(x2, w1, b1, a2=h2, ln=(scale, bias, eps), gelu=True)
    out = gemm(hid, w2, b2, r1=x2, r2=h2)
    return out.reshape(x.shape)


def linear(x, w, b, gemm=gemm_bf16, gelu: bool = False):
    """``x @ w + b`` (then GELU) through the GEMM kernel: the attention
    projections, and the flat route's qkv and MLP."""
    lead = x.shape[:-1]
    out = gemm(x.reshape(-1, x.shape[-1]).contiguous(), w, b, gelu=gelu)
    return out.reshape(*lead, w.shape[1])


# ------------------------------------------------------- w8a8 (K11a, K11b, K11c)


def _pick_bm(m: int, block_rows: int) -> int:
    """Largest divisor of m within the row budget (the JAX package's ``_pick_bm``)."""
    bm = min(m, block_rows)
    while m % bm:
        bm -= 1
    return bm


def int8_tail_chunks(m: int, c: int, hidden: int, tiled: bool, block_rows: int = 256,
                     block_hidden: int = 0) -> int:
    """How many hidden chunks the w8a8 block tail requantises separately.

    Each chunk of the GELU output gets its own per-row int8 scale, so the
    count is part of the function. ``tiled=False`` is K11a's rule (4 chunks
    when they divide the hidden, else 1; JAX ``fused_ln.py:399-401``);
    ``tiled=True`` is K11b's: one chunk per hidden tile of the largest size
    that keeps two int8 weight tiles, double-buffered, and the fp32
    accumulator under ~10 MB of VMEM (JAX ``fused_ln.py:573-588``), or
    ``block_hidden`` when given. 4 at ViT-B, ViT-L and ViT-H."""
    if not tiled:
        return 4 if hidden % 4 == 0 else 1
    if block_hidden:
        if hidden % block_hidden:
            raise ValueError(f"block_hidden {block_hidden} does not divide hidden {hidden}")
        return hidden // block_hidden
    bm = _pick_bm(m, block_rows)
    ht = hidden
    while ht > 128 and (4 * c * ht + bm * c * 4) > 10_000_000:
        nxt = ht // 2
        while hidden % nxt and nxt > 128:
            nxt -= 1
        if nxt == ht or hidden % nxt:
            break
        ht = nxt
    return hidden // ht


def _ln_act(y, scale, bias, eps: float):
    """The JAX package's ``_ln_rows``: fp32 statistics; the normalised value
    rounded to y's dtype, then scale and bias applied in that dtype. fp32
    result for the quantiser."""
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    d = yf - mean
    var = (d * d).mean(-1, keepdim=True)
    dt = y.dtype
    return ((d * torch.rsqrt(var + eps)).to(dt) * scale.to(dt) + bias.to(dt)).float()


def _gelu_f32(h):
    return h * 0.5 * (1.0 + torch.erf(h * 2 ** -0.5))


def fused_ln_matmul_int8_plain(x, scale, bias, wq, ws, b, eps: float = 1e-6):
    """What K11c computes: ``dequant(quant(LN(x)) @ wq) + b`` in x's dtype;
    integer products exact, epilogue ``acc * (xs * ws) + b`` in fp32."""
    lead = x.shape[:-1]
    xq, xs = quant_rows(_ln_act(x.reshape(-1, x.shape[-1]), scale, bias, eps))
    out = int_dot(xq, wq) * (xs * ws.float()) + b.float()
    return out.to(x.dtype).reshape(*lead, wq.shape[-1])


def fused_ln_mlp_int8_plain(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2,
                            eps: float = 1e-6, chunks: int = 4):
    """What K11a / K11b compute: ``y = x (+ attn)``; per hidden chunk c,
    ``h = GELU(dequant(quant(LN(y)) @ w1q[:, c]) + b1[c])`` in fp32,
    requantised per row; ``out = b2 + sum_c dequant_c(quant(h) @ w2q[c])``
    summed in fp32 in chunk order; ``y + out`` in y's dtype."""
    y = x if attn is None else x + attn
    c = y.shape[-1]
    hidden = w1q.shape[-1]
    ch = hidden // chunks
    xq, xs = quant_rows(_ln_act(y.reshape(-1, c), scale, bias, eps))
    out = b2.float().expand(xq.shape[0], c)
    for i in range(chunks):
        sl = slice(i * ch, (i + 1) * ch)
        h = _gelu_f32(int_dot(xq, w1q[:, sl]) * (xs * w1s[sl].float()) + b1[sl].float())
        hq, hs = quant_rows(h)
        out = out + int_dot(hq, w2q[sl]) * (hs * w2s.float())
    return (y.reshape(-1, c) + out.to(y.dtype)).reshape(x.shape)


def _check_int8(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.int8 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: needs a contiguous int8 tensor on {device}, got "
                         f"{t.dtype} contiguous={t.is_contiguous()} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _int8_t(wq: torch.Tensor) -> torch.Tensor:
    """The (out, in) form of an (in, out) int8 weight that the kernel reads
    (s8 wgmma takes both operands K-major), made once."""
    return _derived(wq, "int8_t", lambda v: v.t().contiguous())


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ln_quant(x2, h2, scale, bias, eps):
    """Launch the LN + row quantisation pass: (xq int8 (M, C), xs fp32 (M,)).
    With ``scale`` and ``bias`` None the rows are quantised as they come."""
    m, c = x2.shape
    xq = torch.empty((m, c), dtype=torch.int8, device=x2.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x2.device)
    check(kernels().ysi_ln_quant(_ptr(x2), _ptr(h2), _ptr(_f32(scale)), _ptr(_f32(bias)),
                                 _ptr(xq), _ptr(xs), m, c, float(eps), _stream(x2)), "ln_quant")
    return xq, xs


def _gemm_int8(mode, a, a_scale, wq, ws, b, out, *, r1=None, r2=None, chunk=0):
    m, k = a.shape
    n = wq.shape[1]
    check(kernels().ysi_gemm_int8(mode, _ptr(a), _ptr(_int8_t(wq)), _ptr(a_scale), _ptr(_f32(ws)),
                                  _ptr(_f32(b)), _ptr(r1), _ptr(r2), _ptr(out), m, n, k, chunk,
                                  _stream(a)), "gemm_int8")
    return out


_QKV, _MLP1, _MLP2, _GELU = 0, 1, 2, 3  # the modes of csrc/gemm_int8.cu


def int8_linear_plain(x, wq, ws, b, gelu: bool = False):
    """What :func:`int8_linear` computes: ``ops/quant.py::int8_linear``
    (result in x's dtype), then the exact-erf GELU in fp32 of that rounded
    result, as the JAX flat route applies ``_gelu`` after ``apply_linear``."""
    out = quant.int8_linear(x, wq, ws, b)
    return F.gelu(out.float()).to(x.dtype) if gelu else out


def int8_linear(x, wq, ws, b, gelu: bool = False):
    """``x @ dequant(wq) + b`` (then GELU) with dynamic per-row int8
    activations: the flat route's qkv, mlp1 and mlp2. x (..., C) -> (..., O)
    in x's dtype.

    CPU tensors take :func:`int8_linear_plain`; CUDA tensors launch
    ``csrc/gemm_int8.cu`` (bf16 x, C a multiple of 16, O of 8): the row
    quantisation pass without its LayerNorm, then the int8 GEMM with the row
    and column scales, the bias (and the GELU) in its epilogue."""
    if _on_cpu(x):
        return int8_linear_plain(x, wq, ws, b, gelu)
    lead, c = x.shape[:-1], x.shape[-1]
    o = wq.shape[1]
    if c % 16 or o % 8:
        raise ValueError(f"int8_linear: C={c} must be a multiple of 16, O={o} of 8")
    x2 = x.reshape(-1, c).contiguous()
    _check_bf16("x", x2, x2.shape, x2.device)
    _check_int8("wq", wq, (c, o), x2.device)
    xq, xs = _ln_quant(x2, None, None, None, 0.0)
    out = torch.empty((x2.shape[0], o), dtype=torch.bfloat16, device=x2.device)
    _gemm_int8(_GELU if gelu else _QKV, xq, xs, wq, ws, b, out)
    int8_linear.launches += 1
    return out.reshape(*lead, o)


int8_linear.launches = 0


def fused_ln_matmul_int8(x, scale, bias, wq, ws, b, eps: float = 1e-6, block_rows: int = 256):
    """``int8_linear(LayerNorm(x))`` (K11c): LN1 + per-row int8 quantisation
    + the int8 qkv projection. x (..., C) -> (..., O) in x's dtype.

    CPU tensors take :func:`fused_ln_matmul_int8_plain`; CUDA tensors launch
    ``csrc/gemm_int8.cu`` (bf16 x, C a multiple of 16, O of 8). ``block_rows``
    is the JAX signature's and does not change the function."""
    if _on_cpu(x):
        return fused_ln_matmul_int8_plain(x, scale, bias, wq, ws, b, eps)
    lead, c = x.shape[:-1], x.shape[-1]
    o = wq.shape[1]
    if c % 16 or o % 8:
        raise ValueError(f"fused_ln_matmul_int8: C={c} must be a multiple of 16, O={o} of 8")
    x2 = x.reshape(-1, c).contiguous()
    _check_bf16("x", x2, x2.shape, x2.device)
    _check_int8("wq", wq, (c, o), x2.device)
    xq, xs = _ln_quant(x2, None, scale, bias, eps)
    out = torch.empty((x2.shape[0], o), dtype=torch.bfloat16, device=x2.device)
    _gemm_int8(_QKV, xq, xs, wq, ws, b, out)
    fused_ln_matmul_int8.launches += 1
    return out.reshape(*lead, o)


fused_ln_matmul_int8.launches = 0


def _int8_tail(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2, eps, chunks):
    """The w8a8 block tail on the card: LN + quant, int8 mlp1 (the fp32
    hidden before its GELU), the GELU with the per-chunk requantisation, int8
    mlp2 with the chunk scales folded in and the residual y added."""
    c = x.shape[-1]
    hidden = w1q.shape[1]
    ch = hidden // chunks
    if c % 16 or hidden % chunks or ch % 128:
        raise ValueError(f"w8a8 tail kernel: C={c} must be a multiple of 16 and the hidden "
                         f"chunk {hidden}/{chunks} a multiple of 128")
    x2 = x.reshape(-1, c).contiguous()
    dev = x2.device
    _check_bf16("x", x2, x2.shape, dev)
    h2 = None
    if attn is not None:
        h2 = attn.reshape(-1, c).contiguous()
        _check_bf16("attn", h2, x2.shape, dev)
    _check_int8("w1q", w1q, (c, hidden), dev)
    _check_int8("w2q", w2q, (hidden, c), dev)
    m = x2.shape[0]
    xq, xs = _ln_quant(x2, h2, scale, bias, eps)
    hf = torch.empty((m, hidden), dtype=torch.float32, device=dev)
    _gemm_int8(_MLP1, xq, xs, w1q, w1s, b1, hf)
    hq = torch.empty((m, hidden), dtype=torch.int8, device=dev)
    hs = torch.empty((m, chunks), dtype=torch.float32, device=dev)
    check(kernels().ysi_gelu_quant(_ptr(hf), _ptr(hq), _ptr(hs), m, hidden, ch, _stream(hf)),
          "gelu_quant")
    out = torch.empty((m, c), dtype=torch.bfloat16, device=dev)
    _gemm_int8(_MLP2, hq, hs, w2q, w2s, b2, out, r1=x2, r2=h2, chunk=ch)
    return out.reshape(x.shape)


def fused_ln_mlp_int8(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2,
                      eps: float = 1e-6, block_rows: int = 256):
    """w8a8 block tail (K11a): ``y = x (+ attn); y + int8_mlp2(GELU(
    int8_mlp1(LayerNorm(y))))`` with K11a's chunk count. CPU tensors take
    :func:`fused_ln_mlp_int8_plain`; CUDA tensors launch ``csrc/gemm_int8.cu``."""
    c, hidden = x.shape[-1], w1q.shape[-1]
    chunks = int8_tail_chunks(x.numel() // c, c, hidden, tiled=False)
    if _on_cpu(x):
        return fused_ln_mlp_int8_plain(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                                       chunks=chunks)
    out = _int8_tail(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2, eps, chunks)
    fused_ln_mlp_int8.launches += 1
    return out


fused_ln_mlp_int8.launches = 0


def fused_ln_mlp_tiled_int8(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2,
                            eps: float = 1e-6, block_rows: int = 256, block_hidden: int = 0):
    """w8a8 block tail (K11b) with K11b's chunk count (one per hidden tile of
    the TPU kernel). Same route as :func:`fused_ln_mlp_int8`."""
    c, hidden = x.shape[-1], w1q.shape[-1]
    chunks = int8_tail_chunks(x.numel() // c, c, hidden, tiled=True, block_rows=block_rows,
                              block_hidden=block_hidden)
    if _on_cpu(x):
        return fused_ln_mlp_int8_plain(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                                       chunks=chunks)
    out = _int8_tail(x, attn, scale, bias, w1q, w1s, b1, w2q, w2s, b2, eps, chunks)
    fused_ln_mlp_tiled_int8.launches += 1
    return out


fused_ln_mlp_tiled_int8.launches = 0


__all__ = [
    "fused_ln_matmul", "fused_ln_matmul_int8", "fused_ln_matmul_int8_plain", "fused_ln_mlp",
    "fused_ln_mlp_int8", "fused_ln_mlp_int8_plain", "fused_ln_mlp_tiled_int8", "gemm_bf16",
    "gemm_plain", "int8_linear", "int8_linear_plain", "int8_tail_chunks", "layer_norm",
    "layer_norm_plain", "linear",
]
