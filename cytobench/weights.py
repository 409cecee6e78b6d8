"""The benchmark's weights: YOLOv8 and SAM (the tree of the configuration's
model family, ``cytobench/families/``) drawn from ``--seed`` on the
device, in one call of the card's generator, in bfloat16, the type they are
served in; then laid out as the parameter tree that the program's
``CellSegmentationPipeline(params=(yolo, sam))`` takes (host float32 arrays
holding the bfloat16 values) or, for the reference, as float32 tensors on
the device.

Every leaf is drawn: linear and conv weights at 1.4 / sqrt(fan-in) for
YOLO's SiLU layers and 1 / sqrt(fan-in) elsewhere, biases, position tables
and embeddings small, LayerNorm gains 1 + 0.1 z. The encoder's LayerNorm
gains also carry a few outlier channels (those whose z passes
``ln_outlier_z``, scaled by ``ln_outlier_gain``), as trained ViTs'
post-LayerNorm activations do; the values are the configuration's
``assumed`` group. YOLO's box bins get a falling ramp of biases, so that
the distances, and the boxes, are of the cells' size and not of the frame's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .manifest import family

Leaf = Tuple[Tuple[int, ...], str, float]  # (shape, kind, scale)


def _normal(shape, std):
    return (tuple(shape), "normal", float(std))


def _gain(d, outliers=False):
    return ((d,), "gain_outliers" if outliers else "gain", 0.1)


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def yolo_channels(y: Dict) -> Dict[str, Any]:
    """YOLOv8's stage channels, C2f depths and head widths from its multiples."""
    ch = lambda base: make_divisible(min(base, y["max_channels"]) * y["width_multiple"])  # noqa: E731
    depth = lambda base: max(round(base * y["depth_multiple"]), 1)  # noqa: E731
    stages = tuple(ch(c) for c in (64, 128, 256, 512, 1024))
    det = stages[2:]
    return {"stages": stages, "n1": depth(3), "n2": depth(6), "detect": det,
            "box": max(16, det[0] // 4, y["reg_max"] * 4), "cls": max(det[0], min(y["nc"], 100))}


def yolo_spec(y: Dict) -> Dict:
    a = yolo_channels(y)

    def conv(i, o, k=1):
        return {"w": _normal((k, k, i, o), 1.4 / math.sqrt(i * k * k)), "b": _normal((o,), 0.1)}

    def c2f(ci, co, n):
        c = co // 2
        return {"cv1": conv(ci, 2 * c), "cv2": conv((2 + n) * c, co),
                "m": [{"cv1": conv(c, c, 3), "cv2": conv(c, c, 3)} for _ in range(n)]}

    c1, c2, c3, c4, c5 = a["stages"]
    n1, n2 = a["n1"], a["n2"]
    rm = y["reg_max"]
    detect = []
    for ci in a["detect"]:
        box3 = conv(a["box"], 4 * rm)
        box3["b"] = ((4 * rm,), "bin_ramp", 0.4)
        detect.append({"box1": conv(ci, a["box"], 3), "box2": conv(a["box"], a["box"], 3),
                       "box3": box3, "cls1": conv(ci, a["cls"], 3),
                       "cls2": conv(a["cls"], a["cls"], 3), "cls3": conv(a["cls"], y["nc"])})
    return {
        "backbone": {"stem": conv(3, c1, 3), "down2": conv(c1, c2, 3), "c2f2": c2f(c2, c2, n1),
                     "down3": conv(c2, c3, 3), "c2f3": c2f(c3, c3, n2), "down4": conv(c3, c4, 3),
                     "c2f4": c2f(c4, c4, n2), "down5": conv(c4, c5, 3), "c2f5": c2f(c5, c5, n1),
                     "sppf": {"cv1": conv(c5, c5 // 2), "cv2": conv(c5 * 2, c5)}},
        "head": {"c2f_up4": c2f(c5 + c4, c4, n1), "c2f_up3": c2f(c4 + c3, c3, n1),
                 "down4": conv(c3, c3, 3), "c2f_down4": c2f(c3 + c4, c4, n1),
                 "down5": conv(c4, c4, 3), "c2f_down5": c2f(c4 + c5, c5, n1)},
        "detect": detect,
    }


def _leaves(spec, out: List[Leaf]) -> None:
    if isinstance(spec, dict):
        for k in spec:
            _leaves(spec[k], out)
    elif isinstance(spec, list):
        for s in spec:
            _leaves(s, out)
    elif spec is not None:
        out.append(spec)


def _build(spec, it):
    if isinstance(spec, dict):
        return {k: _build(s, it) for k, s in spec.items()}
    if isinstance(spec, list):
        return [_build(s, it) for s in spec]
    return None if spec is None else next(it)


def draw(spec, seed: int, device, assumed: Dict) -> List[torch.Tensor]:
    """Every leaf of ``spec`` in order, bf16 on ``device``, from one draw of
    the device's generator seeded with ``seed``."""
    leaves: List[Leaf] = []
    _leaves(spec, leaves)
    sizes = [int(np.prod(shape)) for shape, _, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.bfloat16)
    out, o = [], 0
    for (shape, kind, scale), n in zip(leaves, sizes):
        t = z[o:o + n].view(shape)
        o += n
        if kind == "normal":
            t = t * scale
        elif kind == "bin_ramp":  # per side: bias -scale * bin, plus 0.1 z
            rm = shape[0] // 4
            ramp = -scale * torch.arange(rm, device=device, dtype=torch.bfloat16).repeat(4)
            t = ramp + 0.1 * t
        else:
            g = 1.0 + scale * t
            if kind == "gain_outliers":
                g = torch.where(t > assumed["ln_outlier_z"], g * assumed["ln_outlier_gain"], g)
            t = g
        out.append(t.to(torch.bfloat16))
    return out


def weights(cfg: Dict, seed: int, device, host: bool):
    """(YOLO tree, SAM tree): host float32 numpy leaves (``host``, the
    program's ``params=``) or float32 tensors on ``device`` (the reference)."""
    trees = []
    for i, spec in enumerate((yolo_spec(cfg["yolo"]), family(cfg).sam_spec(cfg))):
        leaves = draw(spec, seed * 2 + i, device, cfg["assumed"])
        if host:
            flat = torch.cat([t.reshape(-1) for t in leaves]).cpu().float().numpy()
            arrays, o = [], 0
            for t in leaves:
                arrays.append(flat[o:o + t.numel()].reshape(t.shape))
                o += t.numel()
            leaves = arrays
        else:
            leaves = [t.float() for t in leaves]
        tree = _build(spec, iter(leaves))
        if i == 1:  # one Fourier matrix encodes both the prompts and the image tokens
            tree["shared_image_pe"] = tree["shared_pe"]
        trees.append(tree)
    return tuple(trees)

