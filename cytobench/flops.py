"""Operations and bytes of the benchmarked pipeline, from its shapes alone,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit).

The counts are of the models' arithmetic (a multiply-add is 2 operations),
whatever kernel does it, so a later change to the program moves the time
and not the work. Bytes count what a unit reads and writes once: its
weights in bfloat16, its input and its output activations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "hbm": 3.35e12}
BF16 = 2


def least_s(flops: float, nbytes: float) -> float:
    """The least seconds a unit takes: its operations at the bf16 peak or its
    bytes at the memory rate, whichever is longer."""
    return max(flops / PEAK["bf16"], nbytes / PEAK["hbm"])


def yolo_size(traffic: Dict) -> int:
    """YOLO's letterbox canvas: the frame's side rounded up to 32, at most 640."""
    return min(640, (traffic["frame_size"] + 31) // 32 * 32)


def yolo_convs(y: Dict, size: int) -> List[Tuple[int, int, int, int]]:
    """Every conv of YOLOv8 at a size x size input: (output side, k, in, out)."""
    from .weights import yolo_channels

    a = yolo_channels(y)
    c1, c2, c3, c4, c5 = a["stages"]
    n1, n2 = a["n1"], a["n2"]
    out: List[Tuple[int, int, int, int]] = []

    def c2f(s, ci, co, n):
        c = co // 2
        out.append((s, 1, ci, 2 * c))
        out.extend([(s, 3, c, c)] * (2 * n))
        out.append((s, 1, (2 + n) * c, co))

    s = [size // d for d in (2, 4, 8, 16, 32)]
    out.append((s[0], 3, 3, c1))
    out.append((s[1], 3, c1, c2))
    c2f(s[1], c2, c2, n1)
    out.append((s[2], 3, c2, c3))
    c2f(s[2], c3, c3, n2)
    out.append((s[3], 3, c3, c4))
    c2f(s[3], c4, c4, n2)
    out.append((s[4], 3, c4, c5))
    c2f(s[4], c5, c5, n1)
    out += [(s[4], 1, c5, c5 // 2), (s[4], 1, 2 * c5, c5)]  # SPPF
    c2f(s[3], c5 + c4, c4, n1)
    c2f(s[2], c4 + c3, c3, n1)
    out.append((s[3], 3, c3, c3))
    c2f(s[3], c3 + c4, c4, n1)
    out.append((s[4], 3, c4, c4))
    c2f(s[4], c4 + c5, c5, n1)
    for side, ci in zip(s[2:], a["detect"]):
        out += [(side, 3, ci, a["box"]), (side, 3, a["box"], a["box"]),
                (side, 1, a["box"], 4 * y["reg_max"]), (side, 3, ci, a["cls"]),
                (side, 3, a["cls"], a["cls"]), (side, 1, a["cls"], y["nc"])]
    return out


def yolo_flops(y: Dict, size: int) -> float:
    return sum(2.0 * s * s * k * k * ci * co for s, k, ci, co in yolo_convs(y, size))


def encoder_units(cfg: Dict) -> List[Tuple[float, float, float]]:
    """The encoder as units of (operations an image, activation bytes an
    image, weight bytes): the patch embedding, each layer, the neck."""
    v = cfg["vision_config"]
    c, heads, m, ps = v["hidden_size"], v["num_attention_heads"], v["mlp_dim"], v["patch_size"]
    gs = v["image_size"] // ps
    t = gs * gs
    hd = c // heads
    oc = v["output_channels"]
    units = [(2.0 * t * ps * ps * 3 * c, BF16 * (t * ps * ps * 3 + t * c),
              BF16 * (ps * ps * 3 * c + c))]
    for i in range(v["num_hidden_layers"]):
        w = gs if i in v["global_attn_indexes"] else v["window_size"]
        windows = t // (w * w)
        linear = 2.0 * t * (3 * c * c + c * c + 2 * c * m)
        attn = windows * heads * (4.0 * (w * w) ** 2 * hd + 4.0 * (w * w) * w * hd)
        weights = BF16 * (4 * c * c + 2 * c * m + 4 * c + 3 * c + m + 2 * (2 * w - 1) * hd)
        units.append((linear + attn, BF16 * 2 * t * c, weights))
    units.append((2.0 * t * (c * oc + 9 * oc * oc), BF16 * (t * c + t * oc),
                  BF16 * (c * oc + 9 * oc * oc + 4 * oc)))
    return units


def encoder_flops(cfg: Dict) -> float:
    return sum(f for f, _, _ in encoder_units(cfg))


def encoder_least_s(cfg: Dict, batch: int) -> float:
    """The least seconds of the encoder on a batch: each unit's bound summed."""
    return sum(least_s(batch * f, batch * a + w) for f, a, w in encoder_units(cfg))


def window_side(cfg: Dict, traffic: Dict) -> int:
    """The side of the token window around each cell that the mask head
    upscales: the crop in tokens, plus 3, at most the grid."""
    v = cfg["vision_config"]
    gs = v["image_size"] // v["patch_size"]
    crop = min(traffic["metric_crop"], traffic["frame_size"])
    per_token = v["image_size"] / traffic["frame_size"] / v["patch_size"]
    return min(gs, int(math.ceil(crop * per_token)) + 3)


def prompt_flops(cfg: Dict, traffic: Dict, g: Optional[int] = None) -> float:
    """One box prompt through the two-way decoder over the image's tokens,
    the hypernetwork and IoU heads, and the mask head on a g x g window."""
    v, d = cfg["vision_config"], cfg["mask_decoder_config"]
    gs = v["image_size"] // v["patch_size"]
    t = gs * gs
    c = d["hidden_size"]
    inner = c // d["attention_downsample_rate"]
    masks = d["num_multimask_outputs"] + 1
    tq = 1 + masks + 2

    def attn(nq, nk, dim):
        return 2.0 * (nq * c * dim + 2 * nk * c * dim + nq * dim * c) + 4.0 * nq * nk * dim

    per_layer = attn(tq, tq, c) + attn(tq, t, inner) + 4.0 * tq * c * d["mlp_dim"] \
        + attn(t, tq, inner)
    ih = d["iou_head_hidden_dim"]
    heads = masks * 2.0 * (2 * c * c + c * c // 8) \
        + 2.0 * (c * ih + (d["iou_head_depth"] - 2) * ih * ih + ih * masks)
    g = window_side(cfg, traffic) if g is None else g
    up = 2.0 * g * g * 4 * c * (c // 4) + 2.0 * (2 * g) ** 2 * 4 * (c // 4) * (c // 8) \
        + 2.0 * (4 * g) ** 2 * (c // 8)
    return d["num_hidden_layers"] * per_layer + attn(tq, t, inner) + heads + up


def model_flops_per_image(cfg: Dict, traffic: Dict) -> float:
    """YOLOv8 + the SAM encoder and neck + max_det prompts (the engine pads
    every frame to max_det)."""
    return (yolo_flops(cfg["yolo"], yolo_size(traffic)) + encoder_flops(cfg)
            + traffic["max_det"] * prompt_flops(cfg, traffic))
