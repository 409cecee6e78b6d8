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

On the card one CUDA kernel computes both (``csrc/mbconv.cu``, the stride a
template parameter, the compute type and the residual runtime flags): each
warpgroup of a persistent block walks 8 x 8 output tiles, the weights come by
TMA into shared memory, the expansion and the projection run on wgmma, the
depthwise goes straight into the projection's operand; :func:`s1_plan` and
:func:`s2_plan` say how a shape is laid out, :func:`s1_schedule` and
:func:`s2_schedule` which warpgroup takes which tile. The 4x-expanded
activation never reaches device memory. The source's note says what bounds
it.

Dispatch is by the tensor's device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises. ``mbconv_block.launches`` and
``patch_merge_block.launches`` count launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, kernels
from .autograd import refuse_grad
from .fused_ln import _check_bf16, _f32, _on_cpu, _ptr


COMPUTE_MODES = ("fp32", "bf16")

# csrc/mbconv.cu's geometry: a warpgroup's 8 x 8 output tile and its 10 x 10
# halo at stride 1 (K14; 17 x 17 at stride 2, K15, with chunk-tile rows of 76
# bf16), E in chunks of 64 channels, Co up to 5 boxes of 64.
S1_TILE, S1_HALO, S1_CHUNK, S1_CO_MAX = 8, 100, 64, 320
S2_HALO, S2_CHUNK_LD = 17 * 17, 76
S1_SMEM_BUDGET = 227 * 1024  # the H100's opt-in shared memory of a block

# csrc/mbconv.cu erf_fit's coefficients (Horner order, fp32): erf(x) = x + x P(x^2)
# for |x| < 0.9, else sign(x) (1 - 2^Q(min(|x|, 4) - 2.45)).
ERF_FIT = {
    "P": (-6.106991787e-04, 5.015359726e-03, -2.678134292e-02, 1.128221229e-01,
          -3.761253059e-01, 1.283791512e-01),
    "Q": (2.323069111e-06, -2.012857476e-05, 1.185633591e-04, -6.406772882e-04,
          3.279443365e-03, -1.630568318e-02, -1.359353185e+00, -7.586229801e+00,
          -1.088014221e+01),
}


def erf_fit(x):
    """The stride-1 kernel's erf, evaluated in fp32 as it is (one rounding per
    multiply-add) but with an exact 2^ where the kernel takes the MUFU
    unit's (relative error about 2^-22): numpy array in and out. The plain
    versions use torch's erf."""
    import numpy as np

    f32 = np.float32
    x = np.asarray(x, dtype=f32)

    def fma(a, b, c):  # fp32 fused multiply-add: the exact product and sum, one rounding
        return (a.astype(np.float64) * b + c).astype(f32)

    a, s = np.abs(x), x * x
    p = np.full_like(x, f32(ERF_FIT["P"][0]))
    for c in ERF_FIT["P"][1:]:
        p = fma(p, s, f32(c))
    small = fma(p, x, x)
    u = (np.minimum(a, f32(4)) - f32(2.45)).astype(f32)
    q = np.full_like(x, f32(ERF_FIT["Q"][0]))
    for c in ERF_FIT["Q"][1:]:
        q = fma(q, u, f32(c))
    large = np.copysign(f32(1) - np.exp2(q).astype(f32), x)
    return np.where(a < 0.9, small, large).astype(f32)


def s1_plan(c: int, e: int, co: int) -> tuple:
    """How ``csrc/mbconv.cu`` lays out a stride-1 block of widths (C, E, Co):
    (warpgroups a block, weights resident, shared-memory bytes), the same
    rule as its ``ysi_mbconv_s1``. Resident: all of w1 and w3 loaded once a
    block and shared by 4 warpgroups, where Co is one 64-column box, E <= 256
    and it fits; else 2 warpgroups, each streaming its 64-channel E chunks'
    weights through one w1 slot (C x 64) and one w3 slot (64 x Co). Each
    warpgroup also holds its halo tile (100 x (C + 8)) and chunk tile
    (100 x 72) in bf16; 1024 bytes align the swizzled weights; two barriers
    a warpgroup. Raises ValueError for widths the kernel does not take."""
    if c % 16 or not 0 < c <= 256 or e <= 0 or e % S1_CHUNK or co <= 0 or co % 64 \
            or co > S1_CO_MAX:
        raise ValueError(f"stride-1 MBConv kernel takes C a multiple of 16 up to 256, E a "
                         f"multiple of 64 and Co multiples of 64 up to {S1_CO_MAX}; got {c}, "
                         f"{e}, {co}")

    def smem(resident, wgs):
        weights = 2 * (c * e + e * co) if resident else wgs * 2 * (c * S1_CHUNK + S1_CHUNK * co)
        own = 2 * S1_HALO * (c + 8) + 2 * S1_HALO * (S1_CHUNK + 8)
        return 1024 + weights + wgs * own + 2 * wgs * 8

    if co == 64 and e <= 256 and smem(True, 4) <= S1_SMEM_BUDGET:
        return 4, True, smem(True, 4)
    if smem(False, 2) <= S1_SMEM_BUDGET:
        return 2, False, smem(False, 2)
    raise ValueError(f"stride-1 MBConv kernel: widths {c}, {e}, {co} need "
                     f"{smem(False, 2)} bytes of shared memory, above {S1_SMEM_BUDGET}")


def _pad64(v: int) -> int:
    return -(-v // 64) * 64


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def s2_plan(c: int, e: int, co: int) -> tuple:
    """How ``csrc/mbconv.cu`` lays out a stride-2 merge of widths (C, E, Co):
    (warpgroups a block, weights resident, shared-memory bytes), the rule of
    its ``ysi_patch_merge``. The kernel is built for TinyViT-5M's merges, C
    compiled in: 3 warpgroups at merge0's C 64 with Co in (64, 128], 2 at
    merge1's C 128 with Co in (128, 192]; E a multiple of 32 up to 256 and Co
    a multiple of 32 (a last box of 32 is zero-filled by TMA); w1 and w3
    resident (in 64-channel boxes). The expansion reads x from device memory,
    so a warpgroup holds only its chunk tile (289 x 76 bf16, rounded up to 16
    bytes). Raises ValueError for widths the kernel does not take."""
    wgs = {(64, 2): 3, (128, 3): 2}.get((c, -(-co // 64)))
    ep, cop = _pad64(e), _pad64(co)
    if wgs is None or e <= 0 or e % 32 or ep > 256 or co % 32:
        raise ValueError(f"stride-2 merge kernel takes C 64 with Co in (64, 128] or C 128 with "
                         f"Co in (128, 192], E and Co multiples of 32, E up to 256; got {c}, "
                         f"{e}, {co}")
    smem = 1024 + 2 * (c * ep + ep * cop) + wgs * _pad16(2 * S2_HALO * S2_CHUNK_LD) + 2 * wgs * 8
    if smem > S1_SMEM_BUDGET:
        raise ValueError(f"stride-2 merge kernel: widths {c}, {e}, {co} need {smem} bytes of "
                         f"shared memory, above {S1_SMEM_BUDGET}")
    return wgs, True, smem


def s2_schedule(b: int, h: int, w: int, wgs: int, sms: int) -> tuple:
    """The stride-2 merge's tile schedule: :func:`s1_schedule` over the
    (H / 2, W / 2) output grid."""
    return s1_schedule(b, h // 2, w // 2, wgs, sms)


def s1_schedule(b: int, h: int, w: int, wgs: int, sms: int) -> tuple:
    """``csrc/mbconv.cu``'s tile schedule: (tiles, blocks, the tiles of each
    warpgroup). Output tile i is (image i // (ty tx), tile row i // tx % ty,
    tile column i % tx) of 8 x 8 pixels; warpgroup j of the persistent grid
    (block j // wgs, one block an SM at most) takes tiles j, j + n, j + 2 n,
    ... with n the grid's warpgroups."""
    tx, ty = -(-w // S1_TILE), -(-h // S1_TILE)
    tiles = b * tx * ty
    blocks = min(-(-tiles // wgs), sms)
    n = blocks * wgs
    return tiles, blocks, [list(range(j, tiles, n)) for j in range(n)]


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
    (s1_plan if stride == 1 else s2_plan)(c, e, co)  # raises for widths the kernel does not take
    if stride == 2 and (hgt % 2 or wid % 2):
        raise ValueError(f"stride-2 merge kernel needs an even grid, got {hgt} x {wid}")
    dev = x.device
    _check_bf16("x", x, (b, hgt, wid, c), dev)
    _check_bf16("w1", w1, (c, e), dev)
    _check_bf16("w3", w3, (e, co), dev)
    ho, wo = hgt // stride, wid // stride
    out = torch.empty((b, ho, wo, co), dtype=torch.bfloat16, device=dev)
    wd32 = _f32(wd if wd.dim() == 3 else wd.reshape(3, 3, e))  # the module keeps (3, 3, E)
    args = (_ptr(x), _ptr(w1), _ptr(_f32(b1)), _ptr(wd32), _ptr(_f32(bd)), _ptr(w3),
            _ptr(_f32(b3)), _ptr(out), b, hgt, wid, c, e, co,
            torch.cuda.current_stream(dev).cuda_stream)
    bf16 = int(compute == "bf16")
    err = (kernels().ysi_mbconv_s1(int(residual), bf16, *args) if stride == 1 else
           kernels().ysi_patch_merge(bf16, *args))
    check(err, "mbconv kernel")
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
    refuse_grad("mbconv_block", x, w1, b1, wd, bd, w3, b3)
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
    refuse_grad("patch_merge_block", x, w1, b1, wd, bd, w3, b3)
    out = _launch(x, w1, b1, wd, bd, w3, b3, 2, False, compute)
    patch_merge_block.launches += 1
    patch_merge_block.bf16_launches += compute == "bf16"
    return out


patch_merge_block.launches = 0
patch_merge_block.bf16_launches = 0


__all__ = ["COMPUTE_MODES", "ERF_FIT", "erf_fit", "mbconv_block", "mbconv_plain",
           "patch_merge_block", "s1_plan", "s1_schedule", "s2_plan", "s2_schedule"]
