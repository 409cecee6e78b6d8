"""The port's morphometrics against the JAX package, on the CPU, on cell
masks cut from ``tests/synth.py`` frames."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.ops import metrics as jmetrics
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.ops import metrics as tmetrics
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(1)


def _cells(seed, n_frames=2, k=5, crop=48, h=96, w=128):
    """(B, K, crop, crop) thresholded-cell crops, offsets (B, K, 2), gray (B, H, W)."""
    rng = np.random.default_rng(seed)
    frames = np.stack([make_cell_image(rng, h, w, n_cells=4) for _ in range(n_frames)])
    gray = frames.astype(np.float32).mean(-1)
    masks = np.zeros((n_frames, k, crop, crop), bool)
    offs = np.zeros((n_frames, k, 2), np.int32)
    for b in range(n_frames):
        cell_px = np.argwhere(gray[b] > 100)
        for i in range(k - 1):  # crops centred on cell pixels; the last stays empty
            r, c = cell_px[rng.integers(len(cell_px))]
            r0 = int(np.clip(r - crop // 2, 0, h - crop))
            c0 = int(np.clip(c - crop // 2, 0, w - crop))
            masks[b, i] = gray[b, r0:r0 + crop, c0:c0 + crop] > 100
            offs[b, i] = (r0, c0)
    return frames, gray, masks, offs


def test_perimeter_matches_jax():
    _, _, masks, _ = _cells(0)
    got = tmetrics.perimeter_4n(torch.from_numpy(masks)).numpy()
    want = np.asarray(jmetrics.perimeter_4n(jnp.asarray(masks)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)  # same LUT sums, fp32


def test_batched_cell_metrics_all_keys_match_jax():
    _, gray, masks, offs = _cells(1)
    for b in range(masks.shape[0]):
        got = tmetrics.batched_cell_metrics(
            torch.from_numpy(masks[b]), torch.from_numpy(gray[b]),
            offsets=torch.from_numpy(offs[b]), image_shape=gray.shape[1:],
        )
        want = jmetrics.batched_cell_metrics(
            jnp.asarray(masks[b]), jnp.asarray(gray[b]), offsets=jnp.asarray(offs[b]),
            image_shape=gray.shape[1:],
        )
        assert set(got) == set(jmetrics.METRIC_KEYS) == set(tmetrics.METRIC_KEYS)
        assert masks[b, :-1].any(axis=(1, 2)).all()
        for key in tmetrics.METRIC_KEYS:
            # the same fp32 reductions in another order; hull support points
            # use the same lexicographic tie-break, so the hulls are identical
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       rtol=1e-5, atol=1e-3, err_msg=key)


def test_metrics_stage_matches_jax():
    frames, gray, masks, offs = _cells(2)
    hw = gray.shape[1:]
    got = tengine.metrics_stage(torch.from_numpy(masks), torch.from_numpy(offs),
                                tengine._gray_f32(torch.from_numpy(frames)), hw,
                                tengine.PipelineOptions())
    want = jengine.metrics_stage(jnp.asarray(masks), jnp.asarray(offs),
                                 jengine._gray_f32(jnp.asarray(frames)), hw,
                                 jengine.PipelineOptions())
    for key in tmetrics.METRIC_KEYS:
        assert got[key].shape == masks.shape[:2]
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-3, err_msg=key)
    # empty crops: zeros, deformability 1 (the reference's hull-failure path)
    assert (got["area"][:, -1] == 0).all() and (got["deformability"][:, -1] == 1).all()


def test_pack_csv_outputs_matches_jax():
    rng = np.random.default_rng(3)
    b, k = 2, 4
    boxes = rng.uniform(0, 60, size=(b, k, 4)).astype(np.float32)
    scores = rng.uniform(size=(b, k)).astype(np.float32)
    valid = scores > 0.5
    offs = rng.integers(0, 40, size=(b, k, 2)).astype(np.int32)
    mets = {key: rng.normal(size=(b, k)).astype(np.float32) for key in tmetrics.METRIC_KEYS}
    got = tengine._pack_csv_outputs(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    torch.from_numpy(valid), torch.from_numpy(offs),
                                    {key: torch.from_numpy(v) for key, v in mets.items()})
    want = jengine._pack_csv_outputs(boxes, scores, valid, offs, mets)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert jax.default_backend() == "cpu"
