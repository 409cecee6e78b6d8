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

On the card one CUDA kernel (``csrc/tinyvit_conv.cu``) computes both, with
stride and residual as template parameters: a block takes a tile of output
pixels, runs the expansion over the tile and its halo into shared memory,
the depthwise and the projection, so the 4x-expanded activation never
reaches device memory. Its source note says what bounds it.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``mbconv_block.launches`` and
``patch_merge_block.launches`` count launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels
from .fused_ln import _check_bf16, _f32, _on_cpu, _ptr


def mbconv_plain(x, w1, b1, wd, bd, w3, b3, stride: int = 1, residual: bool = True):
    """fp32 version of both kernels (result in x's dtype). x (B, H, W, C);
    w1 (C, E); wd (3, 3, E) or (3, 3, 1, E); w3 (E, Co)."""
    e = w1.shape[1]
    h = F.gelu(x.float() @ w1.float() + b1.float())
    k = wd.float().reshape(3, 3, e).permute(2, 0, 1)[:, None]  # (E, 1, 3, 3)
    h = F.conv2d(h.permute(0, 3, 1, 2), k, bd.float(), stride=stride, padding=1, groups=e)
    h = F.gelu(h).permute(0, 2, 3, 1) @ w3.float() + b3.float()
    if residual:
        h = F.gelu(x.float() + h)
    return h.to(x.dtype).contiguous()


def _launch(x, w1, b1, wd, bd, w3, b3, stride: int, residual: bool):
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
        stride, int(residual), _ptr(x), _ptr(w1), _ptr(_f32(b1)), _ptr(wd32), _ptr(_f32(bd)),
        _ptr(w3), _ptr(_f32(b3)), _ptr(out), b, hgt, wid, c, e, co,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(err, "tinyvit conv kernel")
    return out


def mbconv_block(x, w1, b1, wd, bd, w3, b3, residual: bool = True):
    """Stride-1 MBConv (K14): ``gelu(x + conv3(gelu(dw3x3(gelu(conv1 x)))))``,
    or without the residual and the outer GELU (TinyViT's stride-1 merge2)."""
    if residual and w3.shape[1] != x.shape[-1]:
        raise ValueError("residual MBConv needs Co == C")
    if _on_cpu(x):
        return mbconv_plain(x, w1, b1, wd, bd, w3, b3, 1, residual)
    out = _launch(x, w1, b1, wd, bd, w3, b3, 1, residual)
    mbconv_block.launches += 1
    return out


mbconv_block.launches = 0


def patch_merge_block(x, w1, b1, wd, bd, w3, b3):
    """Stride-2 patch merge (K15): ``conv3(gelu(dw3x3_s2(gelu(conv1 x))))``,
    (B, H, W, C) -> (B, H/2, W/2, Co)."""
    if _on_cpu(x):
        return mbconv_plain(x, w1, b1, wd, bd, w3, b3, 2, False)
    out = _launch(x, w1, b1, wd, bd, w3, b3, 2, False)
    patch_merge_block.launches += 1
    return out


patch_merge_block.launches = 0


__all__ = ["mbconv_block", "mbconv_plain", "patch_merge_block"]
