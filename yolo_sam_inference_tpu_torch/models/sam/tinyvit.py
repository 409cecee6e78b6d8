"""TinyViT-5M image encoder (the MobileSAM swap) as an ``nn.Module``.

Counterpart of ``yolo_sam_inference_tpu/models/sam/tinyvit.py``. MobileSAM
keeps SAM's prompt encoder and mask decoder and replaces the ViT encoder
with a distilled TinyViT-5M that gives the same (S/16, S/16, 256) embedding:

* patch embed: two stride-2 3x3 conv + bias stems (GELU after the first);
* stage 0: MBConv blocks at S/4, 64 channels (K14);
* merge0, merge1: stride-2 patch merges (K15); merge2 keeps stride 1 so the
  grid stays S/16 (the residual-free MBConv kernel, K14);
* stages 1-3: window blocks (learned per-offset attention bias, K13), each
  followed by the local depthwise conv + LayerNorm + MLP tail (K16);
* neck: 1x1 conv (a matmul) -> LayerNorm (K5) -> 3x3 conv -> LayerNorm.

``mbconv_compute="bf16"`` (the JAX ``tinyvit_encoder(mbconv_compute=)``)
runs K14 and K15 in their bf16 compute mode where the JAX package's fused
path would take them: at the stage-0 MBConvs and merge2 when the width is a
multiple of 8, at the stride-2 merges when H >= 128, H is even and W a
multiple of 16 (JAX ``tinyvit.py:114``, ``:142-145``, ``:156``). Elsewhere
JAX runs the unfused XLA path, so the port keeps fp32 compute there.

BatchNorm is folded into the convs. Weights keep the JAX tree's layouts:
1x1 convs as (in, out) matrices, depthwise weights as (3, 3, C), the stems
and the neck's 3x3 as OIHW for ``F.conv2d``, or as HWIO for ``conv2d_act``
(K17) with ``conv2d_fused`` (stem1's GELU then fused into its epilogue, as
the JAX ``_conv_bn(act="gelu")`` does). ``forward(pix, plain=True)``
runs every kernel's plain PyTorch version on any device (the fp32 oracle);
on the CPU the wrappers take those versions anyway.

Not ported: the s2d stem rewrite (``transform_stem_s2d``), a TPU layout
trick that computes the same function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv2d_fused import conv2d_act, conv2d_act_plain
from ...ops.dw_ln_mlp import dw_conv3x3, dw_conv3x3_plain, dw_ln_mlp
from ...ops.fused_ln import gemm_plain, layer_norm, layer_norm_plain
from ...ops.mbconv_fused import COMPUTE_MODES, mbconv_block, mbconv_plain, patch_merge_block
from ...ops.tinyvit_attention import tinyvit_window_block, tinyvit_window_block_plain

Params = Dict[str, Any]

# The JAX package's default gate of the fused stride-2 merge
# (``_FUSED_MERGE_MIN_H``): smaller inputs take its unfused path.
FUSED_MERGE_MIN_H = 128


@dataclasses.dataclass(frozen=True)
class TinyViTConfig:
    image_size: int = 1024
    embed_dims: Tuple[int, ...] = (64, 128, 160, 320)
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (2, 4, 5, 10)
    window_sizes: Tuple[int, ...] = (7, 7, 14, 7)
    mlp_ratio: float = 4.0
    mbconv_expand: float = 4.0
    output_channels: int = 256

    @property
    def grid_size(self) -> int:
        return self.image_size // 16


def is_tinyvit(params: Params) -> bool:
    """True for a MobileSAM tree: a ``"tinyvit"`` subtree and no ``"vision"`` one."""
    return "tinyvit" in params and "vision" not in params


def _param(a, shape=None) -> nn.Parameter:
    arr = np.asarray(a, np.float32)
    if shape is not None:
        arr = arr.reshape(shape)
    return nn.Parameter(torch.as_tensor(arr), requires_grad=False)


def _conv_weight(w, fused: bool) -> nn.Parameter:
    """HWIO for ``conv2d_act``, OIHW for ``F.conv2d``."""
    w = np.asarray(w)
    return _param(w if fused else w.transpose(3, 2, 0, 1))


class _ConvBlock(nn.Module):
    """The 1x1 -> depthwise 3x3 -> 1x1 record of an MBConv or a patch merge,
    with the compute mode asked for (used where :meth:`compute` allows it)."""

    def __init__(self, p: Params, compute: str = "fp32"):
        super().__init__()
        self.mode = compute
        c1, c2, c3 = p["conv1"], p["conv2"], p["conv3"]
        self.w1, self.b1 = _param(np.asarray(c1["w"])[0, 0]), _param(c1["b"])
        e = np.asarray(c2["w"]).shape[-1]
        self.wd, self.bd = _param(c2["w"], (3, 3, e)), _param(c2["b"])
        self.w3, self.b3 = _param(np.asarray(c3["w"])[0, 0]), _param(c3["b"])

    def args(self):
        return self.w1, self.b1, self.wd, self.bd, self.w3, self.b3

    def compute(self, x, stride: int = 1) -> str:
        """The compute mode at x: the mode asked for where the JAX package's
        fused-path gate passes, else "fp32"."""
        if stride == 2:
            h, w = x.shape[1], x.shape[2]
            fused = h >= FUSED_MERGE_MIN_H and h % 2 == 0 and w % 16 == 0
        else:
            fused = x.shape[2] % 8 == 0
        return self.mode if fused else "fp32"


class MBConv(_ConvBlock):
    def forward(self, x, plain: bool = False):
        if plain:
            return mbconv_plain(x, *self.args(), stride=1, residual=True)
        return mbconv_block(x, *self.args(), compute=self.compute(x))


class PatchMerge(_ConvBlock):
    def __init__(self, p: Params, stride: int, compute: str = "fp32"):
        super().__init__(p, compute)
        self.stride = stride

    def forward(self, x, plain: bool = False):
        if plain:
            return mbconv_plain(x, *self.args(), stride=self.stride, residual=False)
        if self.stride == 2:
            return patch_merge_block(x, *self.args(), compute=self.compute(x, 2))
        return mbconv_block(x, *self.args(), residual=False, compute=self.compute(x))


class TinyViTBlock(nn.Module):
    """``x = x + attn(LN1(pad(x)))`` (K13); ``y = local_conv(x)``;
    ``y + mlp(LN2(y))`` (K16)."""

    def __init__(self, p: Params, heads: int, ws: int):
        super().__init__()
        a = p["attn"]
        self.heads, self.ws = heads, ws
        self.ln1_scale, self.ln1_bias = _param(p["ln1"]["scale"]), _param(p["ln1"]["bias"])
        self.qkv_w, self.qkv_b = _param(a["qkv_w"]), _param(a["qkv_b"])
        self.proj_w, self.proj_b = _param(a["proj_w"]), _param(a["proj_b"])
        self.attn_bias = _param(a["attn_bias"])  # (heads, (2ws-1)^2)
        c = np.asarray(p["local_conv"]["w"]).shape[-1]
        self.local_w, self.local_b = _param(p["local_conv"]["w"], (3, 3, c)), _param(
            p["local_conv"]["b"])
        self.ln2_scale, self.ln2_bias = _param(p["ln2"]["scale"]), _param(p["ln2"]["bias"])
        self.mlp1_w, self.mlp1_b = _param(p["mlp1_w"]), _param(p["mlp1_b"])
        self.mlp2_w, self.mlp2_b = _param(p["mlp2_w"]), _param(p["mlp2_b"])

    def forward(self, x, plain: bool = False):
        route = {"gemm": gemm_plain} if plain else {}
        block = tinyvit_window_block_plain if plain else tinyvit_window_block
        x = block(x, self.attn_bias, self.ln1_scale, self.ln1_bias, self.qkv_w, self.qkv_b,
                  self.proj_w, self.proj_b, self.heads, self.ws, eps=1e-5)
        return dw_ln_mlp(x, self.local_w, self.local_b, self.ln2_scale, self.ln2_bias,
                         self.mlp1_w, self.mlp1_b, self.mlp2_w, self.mlp2_b, eps=1e-5,
                         dw=dw_conv3x3_plain if plain else dw_conv3x3, **route)


class TinyViT(nn.Module):
    """``forward(pix)``: (B, S, S, 3) normalised -> (B, S/16, S/16, output_channels).
    ``conv2d_fused`` puts the two stems and the neck's 3x3 on K17;
    ``mbconv_compute`` ("fp32" or "bf16") is K14's and K15's compute mode
    at the stage-0 MBConvs and the three merges. ``plain=True`` ignores it."""

    def __init__(self, p: Params, cfg: TinyViTConfig, conv2d_fused: bool = False,
                 mbconv_compute: str = "fp32"):
        super().__init__()
        if mbconv_compute not in COMPUTE_MODES:
            raise ValueError(f"mbconv_compute must be one of {COMPUTE_MODES}, got "
                             f"{mbconv_compute!r}")
        self.cfg, self.conv2d_fused = cfg, conv2d_fused
        f, mc = conv2d_fused, mbconv_compute
        self.stem1_w, self.stem1_b = _conv_weight(p["stem1"]["w"], f), _param(p["stem1"]["b"])
        self.stem2_w, self.stem2_b = _conv_weight(p["stem2"]["w"], f), _param(p["stem2"]["b"])
        self.stage0 = nn.ModuleList(MBConv(bp, mc) for bp in p["stage0"])
        self.merge0 = PatchMerge(p["merge0"], 2, mc)
        self.merge1 = PatchMerge(p["merge1"], 2, mc)
        self.merge2 = PatchMerge(p["merge2"], 1, mc)  # stride 1: the grid stays S/16
        self.stages = nn.ModuleList(
            nn.ModuleList(TinyViTBlock(bp, cfg.num_heads[si], cfg.window_sizes[si])
                          for bp in p[f"stage{si}"])
            for si in (1, 2, 3))
        n = p["neck"]
        self.neck_conv1 = _param(n["conv1_w"])  # (C3, oc)
        self.neck_ln1_scale, self.neck_ln1_bias = _param(n["ln1"]["scale"]), _param(
            n["ln1"]["bias"])
        self.neck_conv2 = _conv_weight(n["conv2_w"], f)
        self.neck_ln2_scale, self.neck_ln2_bias = _param(n["ln2"]["scale"]), _param(
            n["ln2"]["bias"])

    def _conv(self, x, w, b, stride: int, act: str = "none", plain: bool = False):
        """NHWC 3x3 conv, padding 1, + act (the JAX package's ``_conv_bn``)."""
        if self.conv2d_fused:
            return (conv2d_act_plain if plain else conv2d_act)(x, w, b, 3, stride, act)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=1)
        y = y.permute(0, 2, 3, 1).contiguous()
        return F.gelu(y) if act == "gelu" else y

    def forward(self, pix: torch.Tensor, plain: bool = False) -> torch.Tensor:
        ln = layer_norm_plain if plain else layer_norm
        x = self._conv(pix, self.stem1_w, self.stem1_b, 2, "gelu", plain)
        x = self._conv(x, self.stem2_w, self.stem2_b, 2, plain=plain)  # /4
        for blk in self.stage0:
            x = blk(x, plain)
        x = self.merge0(x, plain)  # /8
        merges = (self.merge1, self.merge2, None)
        for stage, merge in zip(self.stages, merges):
            for blk in stage:
                x = blk(x, plain)
            if merge is not None:
                x = merge(x, plain)
        y = ln(x @ self.neck_conv1, self.neck_ln1_scale, self.neck_ln1_bias, 1e-6)
        y = self._conv(y, self.neck_conv2, None, 1, plain=plain)
        return ln(y, self.neck_ln2_scale, self.neck_ln2_bias, 1e-6)


def init_tinyvit_params(seed: int, cfg: TinyViTConfig) -> Params:
    """Random-init parameter tree, host numpy fp32: the same draws in the same
    order as the JAX package's ``init_tinyvit_params`` (for an int seed), so
    one seed gives identical weights in both."""
    nrng = np.random.default_rng(seed)
    dtype = np.float32

    def conv(i, o, k=1):
        fan = i * k * k
        return {"w": nrng.normal(0, 1 / math.sqrt(fan), (k, k, i, o)).astype(dtype),
                "b": np.zeros((o,), dtype)}

    def dwconv(c, k=3):
        return {"w": nrng.normal(0, 1 / math.sqrt(k * k), (k, k, 1, c)).astype(dtype),
                "b": np.zeros((c,), dtype)}

    def dense(i, o):
        return nrng.normal(0, 1 / math.sqrt(i), (i, o)).astype(dtype), np.zeros((o,), dtype)

    def ln(d):
        return {"scale": np.ones((d,), dtype), "bias": np.zeros((d,), dtype)}

    d0, d1, d2, d3 = cfg.embed_dims

    def mbconv(c):
        h = int(c * cfg.mbconv_expand)
        return {"conv1": conv(c, h), "conv2": dwconv(h), "conv3": conv(h, c)}

    def merge(ci, co):
        return {"conv1": conv(ci, co), "conv2": dwconv(co), "conv3": conv(co, co)}

    def block(c, heads, ws):
        qkv_w, qkv_b = dense(c, 3 * c)
        proj_w, proj_b = dense(c, c)
        m1w, m1b = dense(c, int(c * cfg.mlp_ratio))
        m2w, m2b = dense(int(c * cfg.mlp_ratio), c)
        return {
            "ln1": ln(c),
            "attn": {"qkv_w": qkv_w, "qkv_b": qkv_b, "proj_w": proj_w, "proj_b": proj_b,
                     "attn_bias": np.zeros((heads, (2 * ws - 1) ** 2), dtype)},
            "local_conv": dwconv(c),
            "ln2": ln(c),
            "mlp1_w": m1w, "mlp1_b": m1b,
            "mlp2_w": m2w, "mlp2_b": m2b,
        }

    def stage(si, c):
        return [block(c, cfg.num_heads[si], cfg.window_sizes[si]) for _ in range(cfg.depths[si])]

    oc = cfg.output_channels
    return {
        "stem1": conv(3, d0 // 2, 3),
        "stem2": conv(d0 // 2, d0, 3),
        "stage0": [mbconv(d0) for _ in range(cfg.depths[0])],
        "merge0": merge(d0, d1),
        "stage1": stage(1, d1),
        "merge1": merge(d1, d2),
        "stage2": stage(2, d2),
        "merge2": merge(d2, d3),
        "stage3": stage(3, d3),
        "neck": {
            "conv1_w": nrng.normal(0, 0.02, (d3, oc)).astype(dtype),
            "ln1": ln(oc),
            "conv2_w": nrng.normal(0, 0.02, (3, 3, oc, oc)).astype(dtype),
            "ln2": ln(oc),
        },
    }


__all__ = ["TinyViT", "TinyViTConfig", "init_tinyvit_params", "is_tinyvit"]
