"""YOLOv8 detector as ``nn.Module``s + DFL decode + the numpy random init.

Counterpart of ``yolo_sam_inference_tpu/models/yolo/model.py``: backbone
Conv/C2f/SPPF, PAN-FPN head, decoupled detect head with Distribution Focal
Loss box regression, BatchNorm folded into the conv kernels. Tensors are
channels-last ``(B, H, W, C)`` throughout, the JAX layout.

Two routes for the convolutions. By default they run on ``F.conv2d`` (NCHW
views of the channels-last data, weights OIHW). With ``conv2d_fused=True``
(``PipelineOptions.conv2d_fused``, the counterpart of the JAX package's
``CONV2D_FUSED=1``) every dense 3x3 conv runs on ``conv2d_act`` (K17, weights
HWIO; the C2f halves go in as channel slices, uncopied) and the 1x1 convs as
its bias-and-activation matmul. ``forward(images, plain=True)`` runs
``conv2d_act_plain`` in fp32 on any device: the oracle on the card.

Modules are built from a parameter tree in the JAX package's layout (conv
weights HWIO, see :func:`init_yolo_params`); ``weights.from_jax_params``
is the bridge.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv2d_fused import conv2d_act, conv2d_act_plain
from .config import YoloConfig

Params = Dict[str, Any]


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)), requires_grad=False)


def _nchw(fn, x, *args, **kwargs):
    """``fn`` (a pooling or resize op of NCHW tensors) on channels-last x."""
    return fn(x.permute(0, 3, 1, 2), *args, **kwargs).permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Conv (+ folded BN) + optional SiLU, 'same' padding, on (B, H, W, C)."""

    def __init__(self, p: Params, stride: int = 1, act: bool = True, fused: bool = False):
        super().__init__()
        w = np.asarray(p["w"])  # (kh, kw, in, out) HWIO
        self.fused = fused
        self.weight = _param(w if fused else w.transpose(3, 2, 0, 1))  # HWIO or OIHW
        self.bias = _param(p["b"])
        self.k, self.stride, self.act = w.shape[0], stride, "silu" if act else "none"

    def forward(self, x, plain: bool = False):
        if plain or self.fused:
            w = self.weight if self.fused else self.weight.permute(2, 3, 1, 0)
            fn = conv2d_act_plain if plain else conv2d_act
            return fn(x, w, self.bias, self.k, self.stride, self.act)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, self.stride, self.k // 2)
        return (F.silu(y) if self.act == "silu" else y).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    def __init__(self, p: Params, shortcut: bool, fused: bool):
        super().__init__()
        self.cv1, self.cv2 = Conv(p["cv1"], fused=fused), Conv(p["cv2"], fused=fused)
        self.shortcut = shortcut

    def forward(self, x, plain: bool = False):
        y = self.cv2(self.cv1(x, plain), plain)
        return x + y if self.shortcut else y


class C2f(nn.Module):
    def __init__(self, p: Params, shortcut: bool, fused: bool):
        super().__init__()
        self.cv1, self.cv2 = Conv(p["cv1"], fused=fused), Conv(p["cv2"], fused=fused)
        self.m = nn.ModuleList(Bottleneck(bp, shortcut, fused) for bp in p["m"])

    def forward(self, x, plain: bool = False):
        y = self.cv1(x, plain)
        c = y.shape[-1] // 2
        parts = [y[..., :c], y[..., c:]]
        for bn in self.m:
            parts.append(bn(parts[-1], plain))
        return self.cv2(torch.cat(parts, dim=-1), plain)


class SPPF(nn.Module):
    def __init__(self, p: Params, fused: bool):
        super().__init__()
        self.cv1, self.cv2 = Conv(p["cv1"], fused=fused), Conv(p["cv2"], fused=fused)

    def forward(self, x, plain: bool = False):
        y = self.cv1(x, plain)
        p1 = _nchw(F.max_pool2d, y, 5, 1, 2)
        p2 = _nchw(F.max_pool2d, p1, 5, 1, 2)
        p3 = _nchw(F.max_pool2d, p2, 5, 1, 2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=-1), plain)


class DetectLevel(nn.Module):
    def __init__(self, p: Params, fused: bool):
        super().__init__()
        self.box = nn.ModuleList([Conv(p["box1"], fused=fused), Conv(p["box2"], fused=fused),
                                  Conv(p["box3"], act=False, fused=fused)])
        self.cls = nn.ModuleList([Conv(p["cls1"], fused=fused), Conv(p["cls2"], fused=fused),
                                  Conv(p["cls3"], act=False, fused=fused)])

    def forward(self, x, plain: bool = False):
        box, cls = x, x
        for cb, cc in zip(self.box, self.cls):
            box, cls = cb(box, plain), cc(cls, plain)
        return torch.cat([box, cls], dim=-1)


def _up2(x):
    return _nchw(F.interpolate, x, scale_factor=2, mode="nearest")


class YoloV8(nn.Module):
    """Backbone + head. ``forward(images)``: (B, S, S, 3) in [0, 1] ->
    per-level raw maps [(B, S/8, S/8, 4*reg_max + nc), (S/16 ...), (S/32 ...)].
    ``conv2d_fused`` routes the convs through ``conv2d_act`` (module
    docstring)."""

    def __init__(self, params: Params, cfg: YoloConfig, conv2d_fused: bool = False):
        super().__init__()
        self.cfg = cfg
        b, h, f = params["backbone"], params["head"], conv2d_fused
        self.stem = Conv(b["stem"], 2, fused=f)
        self.down2 = Conv(b["down2"], 2, fused=f)
        self.c2f2 = C2f(b["c2f2"], True, f)
        self.down3 = Conv(b["down3"], 2, fused=f)
        self.c2f3 = C2f(b["c2f3"], True, f)
        self.down4 = Conv(b["down4"], 2, fused=f)
        self.c2f4 = C2f(b["c2f4"], True, f)
        self.down5 = Conv(b["down5"], 2, fused=f)
        self.c2f5 = C2f(b["c2f5"], True, f)
        self.sppf = SPPF(b["sppf"], f)
        self.c2f_up4 = C2f(h["c2f_up4"], False, f)
        self.c2f_up3 = C2f(h["c2f_up3"], False, f)
        self.head_down4 = Conv(h["down4"], 2, fused=f)
        self.c2f_down4 = C2f(h["c2f_down4"], False, f)
        self.head_down5 = Conv(h["down5"], 2, fused=f)
        self.c2f_down5 = C2f(h["c2f_down5"], False, f)
        self.detect = nn.ModuleList(DetectLevel(dp, f) for dp in params["detect"])

    def forward(self, images: torch.Tensor, plain: bool = False) -> List[torch.Tensor]:
        q = plain
        x = self.c2f2(self.down2(self.stem(images, q), q), q)
        p3 = self.c2f3(self.down3(x, q), q)
        p4 = self.c2f4(self.down4(p3, q), q)
        p5 = self.sppf(self.c2f5(self.down5(p4, q), q), q)
        f4 = self.c2f_up4(torch.cat([_up2(p5), p4], dim=-1), q)
        f3 = self.c2f_up3(torch.cat([_up2(f4), p3], dim=-1), q)
        g4 = self.c2f_down4(torch.cat([self.head_down4(f3, q), f4], dim=-1), q)
        g5 = self.c2f_down5(torch.cat([self.head_down5(g4, q), p5], dim=-1), q)
        return [lvl(f, q) for lvl, f in zip(self.detect, (f3, g4, g5))]


def decode_predictions(
    outs: Sequence[torch.Tensor], cfg: YoloConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DFL decode -> (boxes (B, N, 4) xyxy in input pixels, scores (B, N, nc)):
    anchor centres at (i + 0.5) * stride, ltrb distances as the softmax
    expectation over reg_max bins, sigmoid class scores; fp32."""
    rm, nc = cfg.reg_max, cfg.num_classes
    boxes_all, scores_all = [], []
    for out, stride in zip(outs, cfg.strides):
        b, s1, s2, _ = out.shape
        dev = out.device
        bins = torch.arange(rm, dtype=torch.float32, device=dev)
        box = out[..., :4 * rm].float().reshape(b, s1, s2, 4, rm)
        dist = (torch.softmax(box, dim=-1) * bins).sum(-1)
        cx = torch.arange(s2, dtype=torch.float32, device=dev)[None, :] + 0.5
        cy = torch.arange(s1, dtype=torch.float32, device=dev)[:, None] + 0.5
        x1 = (cx - dist[..., 0]) * stride
        y1 = (cy - dist[..., 1]) * stride
        x2 = (cx + dist[..., 2]) * stride
        y2 = (cy + dist[..., 3]) * stride
        boxes_all.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, s1 * s2, 4))
        scores_all.append(torch.sigmoid(out[..., 4 * rm:].float()).reshape(b, s1 * s2, nc))
    return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def init_yolo_params(seed: int, cfg: YoloConfig) -> Params:
    """Random-init parameter tree (BN folded), host numpy. The same draws in
    the same order as the JAX package's ``init_yolo_params``, so one seed
    gives identical weights in both."""
    nrng = np.random.default_rng(seed)

    def conv(i, o, k=1):
        fan = i * k * k
        return {
            "w": nrng.normal(0.0, 1.0 / math.sqrt(fan), size=(k, k, i, o)).astype(np.float32),
            "b": np.zeros((o,), np.float32),
        }

    def bottleneck(c):
        return {"cv1": conv(c, c, 3), "cv2": conv(c, c, 3)}

    def c2f(ci, co, n):
        c = co // 2
        return {
            "cv1": conv(ci, 2 * c, 1),
            "cv2": conv((2 + n) * c, co, 1),
            "m": [bottleneck(c) for _ in range(n)],
        }

    c1, c2, c3, c4, c5 = cfg.stage_channels
    n1 = cfg.depth(3)
    n2 = cfg.depth(6)
    backbone = {
        "stem": conv(3, c1, 3),
        "down2": conv(c1, c2, 3),
        "c2f2": c2f(c2, c2, n1),
        "down3": conv(c2, c3, 3),
        "c2f3": c2f(c3, c3, n2),
        "down4": conv(c3, c4, 3),
        "c2f4": c2f(c4, c4, n2),
        "down5": conv(c4, c5, 3),
        "c2f5": c2f(c5, c5, n1),
        "sppf": {"cv1": conv(c5, c5 // 2, 1), "cv2": conv(c5 * 2, c5, 1)},
    }
    head = {
        "c2f_up4": c2f(c5 + c4, c4, n1),
        "c2f_up3": c2f(c4 + c3, c3, n1),
        "down4": conv(c3, c3, 3),
        "c2f_down4": c2f(c3 + c4, c4, n1),
        "down5": conv(c4, c4, 3),
        "c2f_down5": c2f(c4 + c5, c5, n1),
    }
    bc, cc = cfg.box_branch_ch, cfg.cls_branch_ch
    detect = [
        {
            "box1": conv(ci, bc, 3),
            "box2": conv(bc, bc, 3),
            "box3": conv(bc, 4 * cfg.reg_max, 1),
            "cls1": conv(ci, cc, 3),
            "cls2": conv(cc, cc, 3),
            "cls3": conv(cc, cfg.num_classes, 1),
        }
        for ci in cfg.detect_channels
    ]
    return {"backbone": backbone, "head": head, "detect": detect}
