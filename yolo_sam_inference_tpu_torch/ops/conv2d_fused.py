"""Dense k x k conv + bias + activation (kernel K17).

Counterpart of ``conv2d_act`` (``yolo_sam_inference_tpu/ops/conv2d_fused.py:428``,
``pallas_call`` at ``:524``). For x (B, H, W, Ci) NHWC, w (k, k, Ci, Co) HWIO
and b (Co,) or None (zero):

    out = act(conv_k(x, w) + b)

accumulated in fp32, the bias and the activation applied to the fp32 sum,
rounded once to x's dtype. ``act`` is "none", "silu" or "gelu" (the exact
erf form; the TPU kernel's rational erf is within 3.4e-5 of it). The
geometries are the JAX package's (``_dense_pad``, ``:131-139``): k = 3 pads
(1, 1), "same", at stride 1 or 2; k = 2 pads (1, 0) at stride 1 (the s2d
native-out downsample: output row r reads input rows r - 1 and r). k = 1 is
``conv1x1_act``'s bias-and-activation matmul (``:121-128``), here the
library GEMM with the bias in its epilogue and the activation after its
rounding to x's dtype: it launches no kernel of the port and is not counted.

The TPU kernel refuses widths that are not a multiple of 16 and odd channel
counts (``conv2d_supported``, ``:384-414``), so the JAX callers send those
convs, the YOLO and TinyViT stems (Ci = 3) among them, to XLA. That is a
lane-layout limit of its width-pair-merged strips, not part of the
function: the port takes every geometry its path gives it, Ci = 3 and any
width included. The ``dotdense`` rewrites (``conv_unrolled_dot``,
``dwconv_unrolled``, ``:142-217``) are XLA programs that compute what
``F.conv2d`` computes; they are not ported.

On the card one CUDA source (``csrc/conv2d_act.cu``) computes it as an
implicit GEMM on the tensor cores (wgmma, the weights by TMA, the im2row as
addresses into a shared-memory halo tile), with a kernel of its own for the
stems (Ci = 3); its source note says what bounds it. x may be a channel
slice of a contiguous NHWC tensor (YOLO's C2f halves ``y[..., :c]``,
``y[..., c:]``): the kernel takes the pixel stride beside Ci, so nothing is
copied on the way in. The main kernel reads the weights as a (k k Ci, Co)
matrix through TMA boxes of 64 columns; :func:`conv_weight_matrix` pads a
copy, made once per weight tensor, where Co is not a multiple of 64.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``conv2d_act.launches`` counts
launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels
from .autograd import refuse_grad
from .fused_ln import _check_bf16, _derived, _f32, _on_cpu, _ptr

ACTS = ("none", "silu", "gelu")
_PAD = {1: (0, 0), 2: (1, 0), 3: (1, 1)}  # (before, after) on each spatial axis


def _check_geometry(k: int, stride: int, act: str) -> None:
    if k not in _PAD:
        raise ValueError(f"conv2d_act takes k in (1, 2, 3), got {k}")
    if act not in ACTS:
        raise ValueError(f"conv2d_act: unknown act {act!r}, one of {ACTS}")
    if stride not in (1, 2) or (k != 3 and stride != 1):
        raise ValueError(f"conv2d_act: k={k} takes stride 1{' or 2' if k == 3 else ''}, "
                         f"got {stride}")


def output_hw(h: int, w: int, k: int, stride: int) -> tuple:
    """(Ho, Wo) of an (H, W) input under the k's padding geometry."""
    lo, hi = _PAD[k]
    return (h + lo + hi - k) // stride + 1, (w + lo + hi - k) // stride + 1


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(y)
    if act == "gelu":
        return F.gelu(y)
    return y


def conv2d_act_plain(x, w, b, k: int, stride: int = 1, act: str = "none"):
    """fp32 version (result contiguous NHWC in x's dtype): ``F.conv2d`` on an
    NCHW view, padding (1, 1) for k = 3, (1, 0) on the top and left for
    k = 2, none for k = 1."""
    _check_geometry(k, stride, act)
    xf = x.float().permute(0, 3, 1, 2)
    if k == 2:
        xf = F.pad(xf, (1, 0, 1, 0))
    y = F.conv2d(xf, w.float().permute(3, 2, 0, 1), None if b is None else b.float(),
                 stride=stride, padding=1 if k == 3 else 0)
    return _act(y, act).permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _pixel_stride(x: torch.Tensor) -> int:
    """Elements between neighbouring pixels of x (B, H, W, Ci), which must be
    a channel slice of a contiguous NHWC tensor."""
    bsz, h, wid, ci = x.shape
    xs = x.stride(2)
    want = (h * wid * xs, wid * xs, xs, 1)
    if xs < ci or any(n > 1 and s != ws for n, s, ws in zip(x.shape, x.stride(), want)):
        raise ValueError(f"conv2d_act: x must be a channel slice of a contiguous NHWC tensor, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    return xs


def conv_weight_matrix(w: torch.Tensor) -> torch.Tensor:
    """The main kernel's weight matrix of w (k, k, Ci, Co): w as a
    (k k Ci, Co) matrix, zero-padded to at least 64 rows and to a multiple
    of 64 columns (the kernel's TMA boxes are 64 columns wide); w's own
    storage where no padding is needed."""
    k, _, ci, co = w.shape
    rows, cols = k * k * ci, -(-co // 64) * 64
    mat = w.reshape(rows, co)
    if rows >= 64 and cols == co:
        return mat
    out = mat.new_zeros((max(rows, 64), cols))
    out[:rows, :co] = mat
    return out


def _launch(x, w, b, k: int, stride: int, act: str):
    bsz, h, wid, ci = x.shape
    co = w.shape[-1]
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise ValueError(f"conv2d_act kernel: x must be bf16, got {x.dtype}")
    xs = _pixel_stride(x)
    small = ci % 8 != 0
    if not small:
        if xs % 8 or x.data_ptr() % 16:
            raise ValueError("conv2d_act kernel: x's pixels must lie on 16-byte boundaries")
    elif k * k * ci > 64:
        raise ValueError(f"conv2d_act kernel takes Ci a multiple of 8, or k*k*Ci <= 64 (the "
                         f"stems); got Ci {ci} at k {k}")
    if co % 8:
        raise ValueError(f"conv2d_act kernel takes Co a multiple of 8, got {co}")
    _check_bf16("w", w, (k, k, ci, co), dev)
    wmat = w.reshape(k * k * ci, co) if small else _derived(w, "conv_wmat", conv_weight_matrix)
    ho, wo = output_hw(h, wid, k, stride)
    out = torch.empty((bsz, ho, wo, co), dtype=torch.bfloat16, device=dev)
    err = kernels().ysi_conv2d_act(
        _ptr(x), _ptr(wmat), _ptr(_f32(b)), _ptr(out), bsz, h, wid, ci, xs, co, wmat.shape[0],
        wmat.shape[1], k, stride, ACTS.index(act), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "conv2d_act kernel")
    return out


def conv2d_act(x, w, b, k: int = 3, stride: int = 1, act: str = "none"):
    """``act(conv_k(x, w) + b)`` (K17) on x (B, H, W, Ci), w (k, k, Ci, Co)
    HWIO, b (Co,) or None -> (B, Ho, Wo, Co); see the module docstring."""
    _check_geometry(k, stride, act)
    if tuple(w.shape[:3]) != (k, k, x.shape[-1]):
        raise ValueError(f"conv2d_act: w {tuple(w.shape)} does not fit k={k}, "
                         f"Ci={x.shape[-1]}")
    if k == 1:  # conv1x1_act: the bias in the library GEMM's epilogue, no kernel of ours
        x2, w2 = x.reshape(-1, x.shape[-1]), w[0, 0].to(x.dtype)
        y = x2 @ w2 if b is None else torch.addmm(b.to(x.dtype), x2, w2)
        return _act(y, act).reshape(*x.shape[:-1], w.shape[-1])
    if _on_cpu(x):
        return conv2d_act_plain(x, w, b, k, stride, act)
    refuse_grad("conv2d_act", x, w, b)
    out = _launch(x, w, b, k, stride, act)
    conv2d_act.launches += 1
    return out


conv2d_act.launches = 0


__all__ = ["ACTS", "conv2d_act", "conv2d_act_plain", "conv_weight_matrix", "output_hw"]
