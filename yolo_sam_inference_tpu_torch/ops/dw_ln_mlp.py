"""TinyViT's block tail: the local depthwise conv, LayerNorm and MLP (kernel K16).

Counterpart of ``dw_ln_mlp`` (``yolo_sam_inference_tpu/ops/dw_ln_mlp.py:88``):

    y = dw3x3(x) + bd;   out = y + mlp2(gelu(mlp1(LN(y))))

The residual is ``y``, not ``x``: TinyViT's ``local_conv`` replaces x.

On the card it runs as three launches: the depthwise 3x3 + bias with the
LayerNorm in the same pass (``dw_conv3x3(..., ln=...)``,
``csrc/tinyvit_conv.cu``), which writes y in bf16 where the TPU kernel
rounds it and LN(y) of that bf16 y; then ``gemm_bf16`` on LN(y) with its
GELU epilogue, and ``gemm_bf16`` with y as the residual. The depthwise is a
pure streaming pass (9 multiply-adds per value), so it is bound by device
memory: one read of x and one write each of y and LN(y).

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``dw_conv3x3.launches`` counts
launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels
from .autograd import refuse_grad
from .fused_ln import _check_bf16, _f32, _on_cpu, _ptr, gemm_bf16, layer_norm_plain

DW_MAX_C = 320  # the kernel's widest tile (csrc/tinyvit_conv.cu DW_MAX_C)


def dw_conv3x3_plain(x, wd, bd, ln=None):
    """fp32 depthwise 3x3 (zero 'same' padding) + bias, result y in x's dtype.
    x (B, H, W, C), wd (3, 3, C) or (3, 3, 1, C). With ``ln`` = (scale, shift,
    eps): returns (y, LN(y)), the LayerNorm of y as rounded to x's dtype."""
    c = x.shape[-1]
    k = wd.float().reshape(3, 3, c).permute(2, 0, 1)[:, None]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k, bd.float(), padding=1, groups=c)
    y = y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    if ln is None:
        return y
    return y, layer_norm_plain(y, ln[0], ln[1], ln[2])


def dw_conv3x3(x, wd, bd, ln=None):
    """Depthwise 3x3 + bias on (B, H, W, C), and with ``ln`` = (scale, shift,
    eps) its LayerNorm in the same pass: returns y, or (y, LN(y)). The kernel
    takes bf16 x and C a multiple of 8, at most 320."""
    if _on_cpu(x):
        return dw_conv3x3_plain(x, wd, bd, ln)
    refuse_grad("dw_conv3x3", x, wd, bd, *(ln or ()))
    b, h, w, c = x.shape
    if c % 8 or c > DW_MAX_C:
        raise ValueError(f"dw_conv3x3 kernel takes C a multiple of 8 up to {DW_MAX_C}, got {c}")
    _check_bf16("x", x, (b, h, w, c), x.device)
    wd32 = _f32(wd if wd.dim() == 3 else wd.reshape(3, 3, c))  # the module keeps (3, 3, C)
    bd32 = _f32(bd)
    scale, shift = (None, None) if ln is None else (_f32(ln[0]), _f32(ln[1]))
    if any(t is not None and t.data_ptr() % 16 for t in (wd32, bd32, scale, shift)):
        raise ValueError("dw_conv3x3 kernel: wd, bd and the LN affine must start on 16-byte "
                         "boundaries")
    y = torch.empty_like(x)
    out = torch.empty_like(x) if ln is not None else None
    eps = 0.0 if ln is None else float(ln[2])
    err = kernels().ysi_dw_conv3x3(_ptr(x), _ptr(wd32), _ptr(bd32), _ptr(scale), _ptr(shift),
                                   _ptr(y), _ptr(out), b, h, w, c, eps,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "dw_conv3x3")
    dw_conv3x3.launches += 1
    return y if ln is None else (y, out)


dw_conv3x3.launches = 0


def dw_ln_mlp(x, wd, bd, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5,
              gemm=gemm_bf16, dw=dw_conv3x3):
    """x (B, H, W, C) -> ``y + mlp2(gelu(mlp1(LN(y))))``, ``y = dw3x3(x) + bd``
    (K16). ``gemm=gemm_plain, dw=dw_conv3x3_plain`` is the plain version on
    any device (the fp32 oracle)."""
    c = x.shape[-1]
    y, ln_y = dw(x, wd, bd, ln=(ln_scale, ln_bias, eps))
    hid = gemm(ln_y.reshape(-1, c), w1, b1, gelu=True)
    return gemm(hid, w2, b2, r1=y.reshape(-1, c)).reshape(x.shape)


__all__ = ["DW_MAX_C", "dw_conv3x3", "dw_conv3x3_plain", "dw_ln_mlp"]
