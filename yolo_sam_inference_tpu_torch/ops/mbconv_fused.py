"""TinyViT's MBConv block and its patch merges (kernels K14 and K15).

Counterparts of ``mbconv_block`` (``yolo_sam_inference_tpu/ops/
mbconv_fused.py:134``) and ``patch_merge_block`` (``ops/merge_fused.py:125``).
Both compute, for a 1x1 expansion ``w1 (C, E)``, a depthwise 3x3 ``wd (3, 3,
1, E)`` of stride 1 or 2 and a 1x1 projection ``w3 (E, Co)`` (biases folded
BatchNorm):

    h = gelu(dw3x3_s(gelu(x @ w1 + b1)) + bd) @ w3 + b3
    out = gelu(x + h)          (MBConv, stride 1, Co = C)
    out = h                    (PatchMerging: stride 2, or stride 1 at merge2)

The depthwise reads the expanded tensor with zero 'same' padding (the
expansion of a padded pixel is zero, not ``gelu(b1)``); at stride 2 on an
even grid only the top and left padding is ever read. GELU is the exact erf
form.

``compute="bf16"`` is the JAX kernels' opt-in mode (``PipelineOptions.
tinyvit_mbconv_compute``): for bf16 x, the GELUs and the 9-tap depthwise
run in bf16 (values rounded to bf16 before each GELU and after each tap);
the products keep their fp32 accumulation. For any other x, or with
``compute="fp32"``, the stretch runs in fp32, as in JAX.

On the card one CUDA kernel (``csrc/tinyvit_conv.cu``) computes both, with
stride, residual and the compute type as template parameters: a block takes
a tile of output pixels, runs the expansion over the tile and its halo into
shared memory, the depthwise and the projection, so the 4x-expanded
activation never reaches device memory. Its source note says what bounds
it.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``mbconv_block.launches`` and
``patch_merge_block.launches`` count launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels
from .fused_ln import _check_bf16, _f32, _on_cpu, _ptr


COMPUTE_MODES = ("fp32", "bf16")


def _check_compute(compute: str) -> None:
    if compute not in COMPUTE_MODES:
        raise ValueError(f"compute must be one of {COMPUTE_MODES}, got {compute!r}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _dw3x3_bf16(h, wd, bd, stride: int):
    """The depthwise 3x3 of bf16 values h (B, H, W, E) in bf16: the bias and
    each tap's running sum rounded to bf16, taps in (dy, dx) order as the
    kernels run them (a bf16 x bf16 product is exact in fp32, so each tap is
    one rounded fused multiply-add)."""
    b, hgt, wid, e = h.shape
    ho, wo = hgt // stride, wid // stride
    hp = F.pad(h, (0, 0, 1, 1, 1, 1))
    w = _bf16(wd.float().reshape(3, 3, e))
    acc = _bf16(bd.float()).expand(b, ho, wo, e)
    for dy in range(3):
        for dx in range(3):
            tap = hp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            acc = _bf16(acc + tap * w[dy, dx])
    return acc


def mbconv_plain(x, w1, b1, wd, bd, w3, b3, stride: int = 1, residual: bool = True,
                 compute: str = "fp32"):
    """fp32 version of both kernels (result in x's dtype). x (B, H, W, C);
    w1 (C, E); wd (3, 3, E) or (3, 3, 1, E); w3 (E, Co). With
    ``compute="bf16"`` and bf16 x it rounds where the kernels' bf16 mode
    does."""
    _check_compute(compute)
    e = w1.shape[1]
    if compute == "bf16" and x.dtype == torch.bfloat16:
        h = _bf16(F.gelu(_bf16(x.float() @ w1.float() + b1.float())))
        h = _bf16(F.gelu(_dw3x3_bf16(h, wd, bd, stride))) @ w3.float() + b3.float()
        if residual:
            h = F.gelu(_bf16(x.float() + h))
        return h.to(x.dtype).contiguous()
    h = F.gelu(x.float() @ w1.float() + b1.float())
    k = wd.float().reshape(3, 3, e).permute(2, 0, 1)[:, None]  # (E, 1, 3, 3)
    h = F.conv2d(h.permute(0, 3, 1, 2), k, bd.float(), stride=stride, padding=1, groups=e)
    h = F.gelu(h).permute(0, 2, 3, 1) @ w3.float() + b3.float()
    if residual:
        h = F.gelu(x.float() + h)
    return h.to(x.dtype).contiguous()


def _launch(x, w1, b1, wd, bd, w3, b3, stride: int, residual: bool, compute: str):
    b, hgt, wid, c = x.shape
    e, co = w1.shape[1], w3.shape[1]
    if c % 32 or e % 32 or co % 32:
        raise ValueError(f"tinyvit conv kernel takes C, E and Co multiples of 32; got {c}, {e}, "
                         f"{co}")
    if stride == 2 and (hgt % 2 or wid % 2):
        raise ValueError(f"stride-2 merge kernel needs an even grid, got {hgt} x {wid}")
    dev = x.device
    _check_bf16("x", x, (b, hgt, wid, c), dev)
    _check_bf16("w1", w1, (c, e), dev)
    _check_bf16("w3", w3, (e, co), dev)
    ho, wo = hgt // stride, wid // stride
    out = torch.empty((b, ho, wo, co), dtype=torch.bfloat16, device=dev)
    wd32 = _f32(wd if wd.dim() == 3 else wd.reshape(3, 3, e))  # the module keeps (3, 3, E)
    err = kernels().ysi_mbconv(
        stride, int(residual), int(compute == "bf16"), _ptr(x), _ptr(w1), _ptr(_f32(b1)),
        _ptr(wd32), _ptr(_f32(bd)), _ptr(w3), _ptr(_f32(b3)), _ptr(out), b, hgt, wid, c, e, co,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "tinyvit conv kernel")
    return out


def mbconv_block(x, w1, b1, wd, bd, w3, b3, residual: bool = True, compute: str = "fp32"):
    """Stride-1 MBConv (K14): ``gelu(x + conv3(gelu(dw3x3(gelu(conv1 x)))))``,
    or without the residual and the outer GELU (TinyViT's stride-1 merge2).
    ``compute`` "fp32" or "bf16" (bf16 x only). The bf16 instantiation's
    launches also count in ``.bf16_launches``."""
    _check_compute(compute)
    if residual and w3.shape[1] != x.shape[-1]:
        raise ValueError("residual MBConv needs Co == C")
    if _on_cpu(x):
        return mbconv_plain(x, w1, b1, wd, bd, w3, b3, 1, residual, compute)
    out = _launch(x, w1, b1, wd, bd, w3, b3, 1, residual, compute)
    mbconv_block.launches += 1
    mbconv_block.bf16_launches += compute == "bf16"
    return out


mbconv_block.launches = 0
mbconv_block.bf16_launches = 0  # those of the compute="bf16" instantiation


def patch_merge_block(x, w1, b1, wd, bd, w3, b3, compute: str = "fp32"):
    """Stride-2 patch merge (K15): ``conv3(gelu(dw3x3_s2(gelu(conv1 x))))``,
    (B, H, W, C) -> (B, H/2, W/2, Co). ``compute`` as for
    :func:`mbconv_block`."""
    _check_compute(compute)
    if _on_cpu(x):
        return mbconv_plain(x, w1, b1, wd, bd, w3, b3, 2, False, compute)
    out = _launch(x, w1, b1, wd, bd, w3, b3, 2, False, compute)
    patch_merge_block.launches += 1
    patch_merge_block.bf16_launches += compute == "bf16"
    return out


patch_merge_block.launches = 0
patch_merge_block.bf16_launches = 0


__all__ = ["COMPUTE_MODES", "mbconv_block", "mbconv_plain", "patch_merge_block"]
