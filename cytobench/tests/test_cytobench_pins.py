"""What the benchmark reads, pinned at the values it had before the model
family's code moved behind ``cytobench/families/``: the operation counts
and least times of both cells, the weight trees drawn (every leaf's shape,
kind and scale, in draw order, and every key path), and the judge's
numbers on one batch of the tiny cell. A change that moves any of them
changes what the benchmark measures."""

import hashlib

import pytest

from cytobench import flops, judge, traffic as gen, weights
from cytobench.manifest import Manifest
from cytobench.run import build_pipeline

from . import tiny

CELLS = {
    "vitb-512-b128": {"model": 214167568384.0, "encoder": 196897406976.0,
                      "prompt": 756118528.0, "least_s": 0.02548318310710617,
                      "sam": (301, "4d556b4a08b06fde", "3bc5a70da78d4a5e")},
    "vith-2048-b8": {"model": 5826807123968.0, "encoder": 5678215200768.0,
                     "prompt": 2810205184.0, "least_s": 0.0459309621902366,
                     "sam": (581, "5acf79ed74878e9a", "33b89d2d63447ca2")},
}
YOLO = (126, "96a13e777f965eba", "fae97053bfd49149")
JUDGED = {  # seed 5, the pool's first batch
    "float32": {"box_ratio": 0.0, "score_ratio": 0.0, "nms_gap_ratio": 0.0, "nms_overlap": 0,
                "det_miss": 0, "offset_miss": 0, "slot_miss": 0, "mask_flip_ratio": 0.0,
                "mask_gap_ratio": 0.0, "metric_exact_miss": 0,
                "metric_rel": 1.531015128372943e-07},
    "bfloat16": {"box_ratio": 1.0, "score_ratio": 0.4540983606557377, "nms_gap_ratio": 0.0,
                 "nms_overlap": 0, "det_miss": 0, "offset_miss": 0, "slot_miss": 0,
                 "mask_flip_ratio": 0.8088235294117647, "mask_gap_ratio": 1.386050165907607,
                 "metric_exact_miss": 0, "metric_rel": 1.4052010699483475e-07},
}


def _h16(x) -> str:
    return hashlib.sha256(repr(x).encode()).hexdigest()[:16]


def _paths(spec, pre=()):
    if isinstance(spec, dict):
        for k, v in spec.items():
            yield from _paths(v, pre + (k,))
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _paths(v, pre + (i,))
    elif spec is not None:
        yield pre


def _tree(spec):
    """(leaves, hash of the leaves in draw order, hash of their key paths)."""
    leaves = []
    weights._leaves(spec, leaves)
    return len(leaves), _h16(leaves), _h16(list(_paths(spec)))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_counts_and_trees_are_the_parents(name):
    m = Manifest(tiny.REPO)
    cell = m.cell(name)
    cfg, traffic = m.config(cell), m.traffic(cell)
    want = CELLS[name]
    assert flops.model_flops_per_image(cfg, traffic) == want["model"]
    assert flops.encoder_flops(cfg) == want["encoder"]
    assert m.family(cfg).prompt_flops(cfg, traffic) == want["prompt"]
    assert flops.encoder_least_s(cfg, traffic["batch"]) == want["least_s"]
    assert _tree(weights.yolo_spec(cfg["yolo"])) == YOLO
    assert _tree(m.family(cfg).sam_spec(cfg)) == want["sam"]


@pytest.mark.parametrize("dtype", sorted(JUDGED))
def test_judged_numbers_are_the_parents(dtype):
    """The tiny cell's program outputs of one batch, through the window's
    calls, judged against the reference."""
    cfg, traffic = tiny.tiny_config(dtype), tiny.tiny_traffic()
    frames = gen.frame_pool(5, traffic)[0]
    pipe = build_pipeline(cfg, traffic, 5, "cpu")
    out = pipe._fetch_outputs(pipe._dispatch_batch(frames, fetch_masks=True))
    trees = weights.weights(cfg, 5, "cpu", host=False)
    got, _ = judge.numbers(cfg, traffic, trees, [(frames, out)], "cpu")
    assert got == JUDGED[dtype]
