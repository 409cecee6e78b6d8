"""The benchmark's weights: YOLOv8 and SAM drawn from ``--seed`` on the
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


def sam_spec(cfg: Dict) -> Dict:
    v, p, d = cfg["vision_config"], cfg["prompt_encoder_config"], cfg["mask_decoder_config"]
    c, ps = v["hidden_size"], v["patch_size"]
    gs = v["image_size"] // ps
    hd = c // v["num_attention_heads"]
    oc = v["output_channels"]

    def dense(i, o):
        return {"w": _normal((i, o), 1.0 / math.sqrt(i)), "b": _normal((o,), 0.02)}

    def ln(n, outliers=False):
        return {"scale": _gain(n, outliers), "bias": _normal((n,), 0.02)}

    def layer(i):
        ws = gs if i in v["global_attn_indexes"] else v["window_size"]
        return {"ln1": ln(c, True),
                "attn": {"qkv": dense(c, 3 * c), "proj": dense(c, c),
                         "rel_pos_h": _normal((2 * ws - 1, hd), 0.1),
                         "rel_pos_w": _normal((2 * ws - 1, hd), 0.1)},
                "ln2": ln(c, True), "mlp1": dense(c, v["mlp_dim"]), "mlp2": dense(v["mlp_dim"], c)}

    di = d["hidden_size"]
    down = di // d["attention_downsample_rate"]

    def attn(inner):
        return {"q": dense(di, inner), "k": dense(di, inner), "v": dense(di, inner),
                "out": dense(inner, di)}

    def ff(i, h, o, depth):
        return {"in": dense(i, h), "hidden": [dense(h, h) for _ in range(depth - 2)],
                "out": dense(h, o)}

    m = d["num_multimask_outputs"] + 1
    return {
        "vision": {
            "patch_embed": {"w": _normal((ps, ps, 3, c), 1.0 / math.sqrt(ps * ps * 3)),
                            "b": _normal((c,), 0.02)},
            "pos_embed": _normal((1, gs, gs, c), 0.1),
            "layers": [layer(i) for i in range(v["num_hidden_layers"])],
            "neck": {"conv1_w": _normal((c, oc), 1.0 / math.sqrt(c)), "ln1": ln(oc),
                     "conv2_w": _normal((3, 3, oc, oc), 1.0 / math.sqrt(9 * oc)), "ln2": ln(oc)},
        },
        "prompt": {"point_embed": _normal((4, p["hidden_size"]), 1.0),
                   "not_a_point": _normal((p["hidden_size"],), 1.0),
                   "no_mask": _normal((p["hidden_size"],), 0.1), "mask_embed": None},
        "decoder": {
            "iou_token": _normal((1, di), 1.0), "mask_tokens": _normal((m, di), 1.0),
            "layers": [{"self_attn": attn(di), "ln1": ln(di), "t2i": attn(down), "ln2": ln(di),
                        "mlp1": dense(di, d["mlp_dim"]), "mlp2": dense(d["mlp_dim"], di),
                        "ln3": ln(di), "i2t": attn(down), "ln4": ln(di)}
                       for _ in range(d["num_hidden_layers"])],
            "final_t2i": attn(down), "ln_final": ln(di),
            "up1_w": _normal((di, di // 4, 2, 2), 1.0 / math.sqrt(di)),
            "up1_b": _normal((di // 4,), 0.02), "up_ln": ln(di // 4),
            "up2_w": _normal((di // 4, di // 8, 2, 2), 1.0 / math.sqrt(di // 4)),
            "up2_b": _normal((di // 8,), 0.02),
            "hyper_mlps": [ff(di, di, di // 8, 3) for _ in range(m)],
            "iou_head": ff(di, d["iou_head_hidden_dim"], m, d["iou_head_depth"]),
        },
        "shared_pe": _normal((2, p["hidden_size"] // 2), 1.0),
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
    for i, spec in enumerate((yolo_spec(cfg["yolo"]), sam_spec(cfg))):
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

