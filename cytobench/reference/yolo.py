"""YOLOv8 detection in plain fp32: backbone (Conv, C2f, SPPF), PAN-FPN head,
decoupled detect head with the Distribution Focal Loss box decode, and
greedy NMS in score order.

Weights are the benchmark's tree: each conv ``{"w": (k, k, in, out), "b":
(out,)}`` with BatchNorm folded in. ``quant="fp8"`` rounds every conv's
input (per image) and weight (per output channel), and the head's outputs,
to float8 e4m3 steps: the lower-precision control of
``cytobench/control.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

STRIDES = (8, 16, 32)


def fake_fp8(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled so that max|x| over ``dims`` is 448."""
    scale = x.abs().amax(dim=tuple(dims), keepdim=True).clamp(min=1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def fake(x: torch.Tensor, w: torch.Tensor, quant: Optional[str], xdims, wdims):
    """(x, w) on float8 steps where ``quant == "fp8"``: x scaled over
    ``xdims``, w over ``wdims``; else as they are."""
    if quant is None:
        return x, w
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}: None or 'fp8'")
    return fake_fp8(x, xdims), fake_fp8(w, wdims)


def out8(x: torch.Tensor, quant: Optional[str], dims) -> torch.Tensor:
    """A model's output on float8 steps where ``quant == "fp8"``."""
    return fake_fp8(x, dims) if quant == "fp8" else x


def conv(p: Dict, x: torch.Tensor, stride: int = 1, act: bool = True,
         quant: Optional[str] = None) -> torch.Tensor:
    """NCHW x -> NCHW, 'same' padding, then SiLU."""
    x, w = fake(x, p["w"].permute(3, 2, 0, 1), quant, (1, 2, 3), (1, 2, 3))
    y = F.conv2d(x, w, p["b"], stride, w.shape[-1] // 2)
    return F.silu(y) if act else y


def c2f(p: Dict, x: torch.Tensor, shortcut: bool, quant) -> torch.Tensor:
    y = conv(p["cv1"], x, quant=quant)
    parts = list(y.chunk(2, dim=1))
    for m in p["m"]:
        z = conv(m["cv2"], conv(m["cv1"], parts[-1], quant=quant), quant=quant)
        parts.append(parts[-1] + z if shortcut else z)
    return conv(p["cv2"], torch.cat(parts, dim=1), quant=quant)


def sppf(p: Dict, x: torch.Tensor, quant) -> torch.Tensor:
    y = conv(p["cv1"], x, quant=quant)
    pools = [y]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return conv(p["cv2"], torch.cat(pools, dim=1), quant=quant)


def forward(tree: Dict, images: torch.Tensor, quant: Optional[str] = None) -> List[torch.Tensor]:
    """(B, S, S, 3) in [0, 1] -> the three levels' raw maps (B, S/s, S/s, 4 reg_max + nc),
    computed in the type of the tree's weights."""
    b, h = tree["backbone"], tree["head"]
    x = images.permute(0, 3, 1, 2).to(b["stem"]["w"].dtype)
    x = conv(b["stem"], x, 2, quant=quant)
    x = c2f(b["c2f2"], conv(b["down2"], x, 2, quant=quant), True, quant)
    p3 = c2f(b["c2f3"], conv(b["down3"], x, 2, quant=quant), True, quant)
    p4 = c2f(b["c2f4"], conv(b["down4"], p3, 2, quant=quant), True, quant)
    p5 = sppf(b["sppf"], c2f(b["c2f5"], conv(b["down5"], p4, 2, quant=quant), True, quant), quant)
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
    f4 = c2f(h["c2f_up4"], torch.cat([up(p5), p4], 1), False, quant)
    f3 = c2f(h["c2f_up3"], torch.cat([up(f4), p3], 1), False, quant)
    g4 = c2f(h["c2f_down4"], torch.cat([conv(h["down4"], f3, 2, quant=quant), f4], 1), False,
             quant)
    g5 = c2f(h["c2f_down5"], torch.cat([conv(h["down5"], g4, 2, quant=quant), p5], 1), False,
             quant)
    outs = []
    for lvl, f in zip(tree["detect"], (f3, g4, g5)):
        box, cls = f, f
        for i in (1, 2, 3):
            box = conv(lvl[f"box{i}"], box, act=i < 3, quant=quant)
            cls = conv(lvl[f"cls{i}"], cls, act=i < 3, quant=quant)
        outs.append(out8(torch.cat([box, cls], 1).permute(0, 2, 3, 1), quant, (1, 2, 3)))
    return outs


def decode(outs: Sequence[torch.Tensor], reg_max: int) -> Tuple[torch.Tensor, torch.Tensor,
                                                                  torch.Tensor]:
    """-> (boxes (B, N, 4) xyxy letterbox pixels, best class score (B, N),
    each anchor's stride (N,)). A side's distance is the expectation of the
    softmax over reg_max bins; anchors sit at cell centres."""
    boxes, scores, strides = [], [], []
    for out, s in zip(outs, STRIDES):
        b, gh, gw, _ = out.shape
        dist = torch.softmax(out[..., :4 * reg_max].float().reshape(b, gh, gw, 4, reg_max), -1)
        dist = (dist * torch.arange(reg_max, device=out.device, dtype=torch.float32)).sum(-1)
        cx = torch.arange(gw, device=out.device, dtype=torch.float32)[None, :] + 0.5
        cy = torch.arange(gh, device=out.device, dtype=torch.float32)[:, None] + 0.5
        xyxy = torch.stack([cx - dist[..., 0], cy - dist[..., 1], cx + dist[..., 2],
                            cy + dist[..., 3]], -1) * s
        boxes.append(xyxy.reshape(b, gh * gw, 4))
        scores.append(torch.sigmoid(out[..., 4 * reg_max:].float()).amax(-1).reshape(b, gh * gw))
        strides.append(torch.full((gh * gw,), float(s), device=out.device))
    return torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(strides)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes a (..., N, 4) against b (..., M, 4) -> (..., N, M)."""
    area = lambda t: (t[..., 2] - t[..., 0]).clamp(min=0) * (t[..., 3] - t[..., 1]).clamp(min=0)  # noqa: E731
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter).clamp(min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_det: int, iou_thr: float, conf: float,
        candidates: int):
    """Greedy NMS of one image's (N, 4) boxes among its ``candidates`` best
    scores: a box is kept when its score reaches ``conf`` and no kept box
    overlaps it by more than ``iou_thr``. -> indices of the kept, best first
    (at most ``max_det``)."""
    order = torch.argsort(scores, descending=True, stable=True)[:candidates]
    over = (iou(boxes[order], boxes[order]) > iou_thr).cpu().numpy()
    ok = (scores[order] >= conf).cpu().numpy()
    kept: List[int] = []
    for i in range(order.numel()):
        if len(kept) == max_det or not ok[i]:
            break
        if not over[i, kept].any():
            kept.append(i)
    return order[kept]
