"""YOLOv8 detector as ``nn.Module``s + DFL decode + the numpy random init.

Counterpart of ``yolo_sam_inference_tpu/models/yolo/model.py``: backbone
Conv/C2f/SPPF, PAN-FPN head, decoupled detect head with Distribution Focal
Loss box regression, BatchNorm folded into the conv kernels. The public
functions keep the JAX layout, channels-last ``(B, H, W, C)``; inside, the
convolutions run on ``F.conv2d`` (NCHW views of the channels-last data).

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

from .config import YoloConfig

Params = Dict[str, Any]


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)), requires_grad=False)


class Conv(nn.Module):
    """Conv (+ folded BN) + optional SiLU, 'same' padding."""

    def __init__(self, p: Params, stride: int = 1, act: bool = True):
        super().__init__()
        w = np.asarray(p["w"])  # (kh, kw, in, out) HWIO
        self.weight = _param(w.transpose(3, 2, 0, 1))
        self.bias = _param(p["b"])
        self.stride, self.pad, self.act = stride, w.shape[0] // 2, act

    def forward(self, x):
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.pad)
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    def __init__(self, p: Params, shortcut: bool):
        super().__init__()
        self.cv1, self.cv2, self.shortcut = Conv(p["cv1"]), Conv(p["cv2"]), shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    def __init__(self, p: Params, shortcut: bool):
        super().__init__()
        self.cv1, self.cv2 = Conv(p["cv1"]), Conv(p["cv2"])
        self.m = nn.ModuleList(Bottleneck(bp, shortcut) for bp in p["m"])

    def forward(self, x):
        y = self.cv1(x)
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for bn in self.m:
            parts.append(bn(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.cv1, self.cv2 = Conv(p["cv1"]), Conv(p["cv2"])

    def forward(self, x):
        y = self.cv1(x)
        p1 = F.max_pool2d(y, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class DetectLevel(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.box = nn.Sequential(Conv(p["box1"]), Conv(p["box2"]), Conv(p["box3"], act=False))
        self.cls = nn.Sequential(Conv(p["cls1"]), Conv(p["cls2"]), Conv(p["cls3"], act=False))

    def forward(self, x):
        return torch.cat([self.box(x), self.cls(x)], dim=1)


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class YoloV8(nn.Module):
    """Backbone + head. ``forward(images)``: (B, S, S, 3) in [0, 1] ->
    per-level raw maps [(B, S/8, S/8, 4*reg_max + nc), (S/16 ...), (S/32 ...)]."""

    def __init__(self, params: Params, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        b, h = params["backbone"], params["head"]
        self.stem = Conv(b["stem"], 2)
        self.down2 = Conv(b["down2"], 2)
        self.c2f2 = C2f(b["c2f2"], True)
        self.down3 = Conv(b["down3"], 2)
        self.c2f3 = C2f(b["c2f3"], True)
        self.down4 = Conv(b["down4"], 2)
        self.c2f4 = C2f(b["c2f4"], True)
        self.down5 = Conv(b["down5"], 2)
        self.c2f5 = C2f(b["c2f5"], True)
        self.sppf = SPPF(b["sppf"])
        self.c2f_up4 = C2f(h["c2f_up4"], False)
        self.c2f_up3 = C2f(h["c2f_up3"], False)
        self.head_down4 = Conv(h["down4"], 2)
        self.c2f_down4 = C2f(h["c2f_down4"], False)
        self.head_down5 = Conv(h["down5"], 2)
        self.c2f_down5 = C2f(h["c2f_down5"], False)
        self.detect = nn.ModuleList(DetectLevel(dp) for dp in params["detect"])

    def forward(self, images: torch.Tensor) -> List[torch.Tensor]:
        x = images.permute(0, 3, 1, 2)  # NCHW view of channels-last data
        x = self.c2f2(self.down2(self.stem(x)))
        p3 = self.c2f3(self.down3(x))
        p4 = self.c2f4(self.down4(p3))
        p5 = self.sppf(self.c2f5(self.down5(p4)))
        f4 = self.c2f_up4(torch.cat([_up2(p5), p4], dim=1))
        f3 = self.c2f_up3(torch.cat([_up2(f4), p3], dim=1))
        g4 = self.c2f_down4(torch.cat([self.head_down4(f3), f4], dim=1))
        g5 = self.c2f_down5(torch.cat([self.head_down5(g4), p5], dim=1))
        return [lvl(f).permute(0, 2, 3, 1) for lvl, f in zip(self.detect, (f3, g4, g5))]


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
