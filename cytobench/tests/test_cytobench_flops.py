"""The operation counts of cytobench/flops.py against hand counts and against
torch's own count of the reference's products, at a tiny configuration; and
the full-size totals that PERF.md quotes."""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from cytobench import flops
from cytobench.manifest import family
from cytobench.reference import sam, yolo
from cytobench.weights import weights

from . import tiny


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_tiny_encoder_by_hand():
    cfg = tiny.tiny_config()
    v = cfg["vision_config"]
    c, m, heads, ps = 32, 64, 2, 8
    gs, t, hd = 32, 1024, 16
    linear = 2 * t * (4 * c * c + 2 * c * m)
    win = lambda w: (t // (w * w)) * heads * (4 * (w * w) ** 2 * hd + 4 * (w * w) * w * hd)  # noqa: E731
    hand = 2 * t * ps * ps * 3 * c + 2 * (linear) + win(16) + win(gs) \
        + 2 * t * (c * 16 + 9 * 16 * 16)
    assert v["window_size"] == 16 and v["global_attn_indexes"] == [1]
    assert flops.encoder_flops(cfg) == hand


def test_counts_match_torch_on_the_reference():
    cfg = tiny.tiny_config()
    traffic = tiny.tiny_traffic()
    ytree, stree = weights(cfg, 1, "cpu", host=False)
    v = cfg["vision_config"]
    pix = torch.zeros(1, v["image_size"], v["image_size"], 3)
    assert _counted(lambda: sam.encoder(stree["vision"], v, pix)) == flops.encoder_flops(cfg)
    size = flops.yolo_size(traffic)
    lb = torch.zeros(1, size, size, 3)
    assert _counted(lambda: yolo.forward(ytree, lb)) == flops.yolo_flops(cfg["yolo"], size)
    gs = v["image_size"] // v["patch_size"]
    emb = torch.zeros(1, gs, gs, v["output_channels"])
    sparse = torch.zeros(1, 2, 16)

    def prompt():
        hyper, keys = sam.decode(stree, emb, sparse, 2)
        sam.mask_logits(stree, keys, hyper)

    d = cfg["mask_decoder_config"]
    c, masks = d["hidden_size"], d["num_multimask_outputs"] + 1
    ih = d["iou_head_hidden_dim"]
    # the reference runs the first hypernetwork MLP only, and no IoU head
    unused = (masks - 1) * 2 * (2 * c * c + c * c // 8) + 2 * (c * ih + ih * ih + ih * masks)
    # and it encodes the token grid's positions: (gs^2, 2) @ (2, c / 2), once an image
    image_pe = 2 * gs * gs * 2 * (c // 2)
    assert _counted(prompt) == family(cfg).prompt_flops(cfg, traffic, g=gs) - unused + image_pe


def test_full_size_totals():
    import json

    b = json.loads((tiny.HERE / "configs" / "sam-vit-b.json").read_text())
    h = json.loads((tiny.HERE / "configs" / "sam-vit-h.json").read_text())
    assert math.isclose(flops.encoder_flops(b), 0.196e12, rel_tol=0.01)
    assert math.isclose(flops.encoder_flops(h), 5.65e12, rel_tol=0.01)
    assert 4.5e9 < flops.yolo_flops(b["yolo"], 512) < 5.7e9
