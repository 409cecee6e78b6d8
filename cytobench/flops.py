"""Operations and bytes of the benchmarked pipeline, from its shapes alone,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit).

The counts are of the models' arithmetic (a multiply-add is 2 operations),
whatever kernel does it, so a later change to the program moves the time
and not the work. Bytes count what a unit reads and writes once: its
weights in bfloat16, its input and its output activations. YOLO's counts
are here; the SAM encoder's units and a prompt's operations are the
configuration's model family's (``cytobench/families/``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .manifest import family

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


def encoder_flops(cfg: Dict) -> float:
    return sum(f for f, _, _ in family(cfg).encoder_units(cfg))


def encoder_least_s(cfg: Dict, batch: int) -> float:
    """The least seconds of the encoder on a batch: each unit's bound summed."""
    return sum(least_s(batch * f, batch * a + w) for f, a, w in family(cfg).encoder_units(cfg))


def model_flops_per_image(cfg: Dict, traffic: Dict) -> float:
    """YOLOv8 + the SAM encoder and neck + max_det prompts (the engine pads
    every frame to max_det)."""
    return (yolo_flops(cfg["yolo"], yolo_size(traffic)) + encoder_flops(cfg)
            + traffic["max_det"] * family(cfg).prompt_flops(cfg, traffic))
