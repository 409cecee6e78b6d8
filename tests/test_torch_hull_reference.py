"""The port's ``hull_mode="reference"`` against the JAX package, on the CPU.

``rasterized_hull_measures`` (the reference's rasterise-and-remeasure hull)
beside JAX's on the same masks: areas exact (the same pixel count), hull
perimeters within 1e-5 relative (the same 4-neighbourhood sum in another
order); and beside ``tests/oracle_refhull.py``, the reference's procedure in
numpy, at the JAX test's bounds. Then the single-cell host API and the
metrics stage in both hull modes, and the refusal of an unknown mode.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracle_refhull import make_cell_mask, reference_hull_measures
from test_metrics import random_blob
from test_torch_metrics import _cells
from yolo_sam_inference_tpu.ops import metrics as jmetrics
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.ops import metrics as tmetrics
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(1)


def _masks(kind: str) -> np.ndarray:
    """(N, h, w) bool masks of one kind, from a numpy seed."""
    rng = np.random.default_rng({"cells": 3, "blobs": 5, "edges": 7, "empty": 9}[kind])
    if kind == "cells":
        return np.stack([make_cell_mask(rng) for _ in range(24)])
    if kind == "blobs":
        return np.stack([random_blob(rng) for _ in range(24)])
    if kind == "empty":  # all empty, one pixel, one row, one column
        m = np.zeros((4, 40, 40), bool)
        m[1, 17, 23] = True
        m[2, 9, 3:31] = True
        m[3, 2:37, 11] = True
        return m
    # cells cut by the crop's edges and corners: the edge rows and the
    # axial half-planes (row_ok) decide these counts
    full = np.stack([make_cell_mask(rng) for _ in range(12)])
    h, w = full.shape[1:]
    out = []
    for i, m in enumerate(full):
        r, c = np.argwhere(m).mean(axis=0).astype(int)
        dr, dc = [(r, c), (r - h // 2, c), (r, c - w // 2), (r - h // 2, c - w // 2)][i % 4]
        out.append(np.roll(m, (h // 2 - dr, w // 2 - dc), axis=(0, 1))[:h // 2, :w // 2])
    return np.stack(out)


@pytest.mark.parametrize("kind", ["cells", "blobs", "edges", "empty"])
def test_rasterized_hull_matches_jax(kind):
    masks = _masks(kind)
    area, perim = tmetrics.rasterized_hull_measures(torch.from_numpy(masks))
    jarea, jperim = jmetrics.rasterized_hull_measures(jnp.asarray(masks))
    np.testing.assert_array_equal(area.numpy(), np.asarray(jarea))
    np.testing.assert_allclose(perim.numpy(), np.asarray(jperim), rtol=1e-5, atol=0)
    if kind == "empty":
        assert area[0] == perim[0] == 0 and (area[1:] > 0).all()
    else:
        assert (area > 0).all()


@pytest.mark.parametrize("seed", [3, 21])
def test_rasterized_hull_matches_the_reference_procedure(seed):
    """At the JAX test's bounds (``test_metrics.py``): perimeter 0.01,
    area within a few boundary pixels, deformability 2e-3."""
    rng = np.random.default_rng(seed)
    masks = [m for m in (make_cell_mask(rng) for _ in range(30)) if m.sum() >= 20]
    assert len(masks) >= 25
    area, perim = tmetrics.rasterized_hull_measures(torch.from_numpy(np.stack(masks)))
    for m, a, p in zip(masks, area.tolist(), perim.tolist()):
        ref_a, ref_p = reference_hull_measures(m)
        assert p == pytest.approx(ref_p, abs=0.01)
        assert abs(a - ref_a) <= 6.0
        d_ref = 1.0 - 2.0 * math.sqrt(math.pi * ref_a) / ref_p
        assert abs(1.0 - 2.0 * math.sqrt(math.pi * a) / p - d_ref) < 2e-3


def _compare_scalars(got, want):
    assert list(got) == list(want)
    for key, v in want.items():
        assert type(got[key]) is type(v), key
        if isinstance(v, int):
            assert got[key] == v, key
        else:
            assert got[key] == pytest.approx(v, rel=1e-5, abs=1e-5), key


@pytest.mark.parametrize("hull_mode", ["polygon", "reference"])
@pytest.mark.parametrize("kind", ["cells", "edges"])
def test_calculate_metrics_matches_jax(kind, hull_mode):
    """The host API: the same keys in the same order and the same Python
    types; ints exact, floats within 1e-5."""
    masks = _masks(kind)[:3]
    rng = np.random.default_rng(1)
    for m in masks:
        image = rng.integers(0, 255, size=(*m.shape, 3)).astype(np.uint8)
        _compare_scalars(tmetrics.calculate_metrics(image, m, hull_mode, device="cpu"),
                         jmetrics.calculate_metrics(image, m, hull_mode))


def test_calculate_metrics_no_convex_hull_matches_jax():
    rng = np.random.default_rng(2)
    for m in _masks("blobs")[:3]:
        image = rng.integers(0, 255, size=(*m.shape, 3)).astype(np.uint8)
        got = tmetrics.calculate_metrics_no_convex_hull(image, m, device="cpu")
        _compare_scalars(got, jmetrics.calculate_metrics_no_convex_hull(image, m))
        assert got["circularity"] == got["deformability"] == 0.5
        assert got["convex_hull_area"] == got["area"]


def test_reference_metrics_stage_matches_jax():
    """The engine's metrics stage in reference mode on thresholded cell crops
    (one empty per frame): every metric, the tolerances of
    ``test_torch_metrics.py``; hull areas exact."""
    frames, gray, masks, offs = _cells(4)
    hw = gray.shape[1:]
    got = tengine.metrics_stage(torch.from_numpy(masks), torch.from_numpy(offs),
                                tengine._gray_f32(torch.from_numpy(frames)), hw,
                                tengine.PipelineOptions(hull_mode="reference"))
    want = jengine.metrics_stage(jnp.asarray(masks), jnp.asarray(offs),
                                 jengine._gray_f32(jnp.asarray(frames)), hw,
                                 jengine.PipelineOptions(hull_mode="reference"))
    for key in tmetrics.METRIC_KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-3, err_msg=key)
    np.testing.assert_array_equal(got["convex_hull_area"].numpy(),
                                  np.asarray(want["convex_hull_area"]))
    polygon = tengine.metrics_stage(torch.from_numpy(masks), torch.from_numpy(offs),
                                    tengine._gray_f32(torch.from_numpy(frames)), hw,
                                    tengine.PipelineOptions())
    live = masks.any(axis=(2, 3))
    assert (got["deformability"][live] != polygon["deformability"][live]).any()


@pytest.mark.parametrize("where", ["cell_metrics", "engine options"])
def test_unknown_hull_mode_raises(where):
    masks = _masks("cells")[:2]
    gray = np.zeros(masks.shape[1:], np.float32)
    with pytest.raises(ValueError, match="hull_mode"):
        jmetrics.batched_cell_metrics(jnp.asarray(masks), jnp.asarray(gray), hull_mode="exact")
    with pytest.raises(ValueError, match="hull_mode"):
        if where == "cell_metrics":
            tmetrics.batched_cell_metrics(torch.from_numpy(masks), torch.from_numpy(gray),
                                          hull_mode="exact")
        else:
            tengine.CellSegmentationPipeline(device="cpu",
                                             options=tengine.PipelineOptions(hull_mode="exact"))

