"""The port's morphometrics against the JAX package, on the CPU, on cell
masks cut from ``tests/synth.py`` frames, and the single-cell API on whole
frames against JAX and a float64 numpy oracle of the reference's
brightness disk."""

import functools

import numpy as np
import pytest
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


# whole frames (height, width) for the single-cell API: a narrow frame wider
# than 4096, one with both sides above 2048, two narrow frames at 2000 and
# 2048 columns, and a 3-row line
FRAMES = ((48, 5000), (2100, 2300), (64, 2000), (48, 2048), (3, 9000))
# the keys that depend on the centroid; JAX sums it in fp32 (F13)
CENTROID_KEYS = ("mean_brightness", "brightness_std")


@functools.lru_cache(maxsize=1)
def _frames():
    """{(h, w): (image (h, w, 3) uint8, mask (h, w) bool)}: a uniform random
    RGB image (one draw of ``default_rng(0)`` a frame, in FRAMES' order) and
    the centred ellipse with semi-axes 0.45 h and 0.45 w."""
    rng = np.random.default_rng(0)
    out = {}
    for h, w in FRAMES:
        image = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        out[(h, w)] = image, ((yy - h / 2) / (0.45 * h)) ** 2 + ((xx - w / 2) / (0.45 * w)) ** 2 <= 1
    return out


def _oracle(image: np.ndarray, mask: np.ndarray):
    """The reference's centroid and brightness in float64: the mean pixel
    position, and the mean and std of the gray image over the disk of radius
    int(0.1 min(H, W)) around it (the reference's ``utils/metrics.py:84-94``);
    0 and 0 for a disk that holds no pixel centre, as both packages give (a
    radius of 0 around a centroid off the pixel grid; numpy's mean would be
    NaN)."""
    rows, cols = np.nonzero(mask)
    cr, cc = rows.mean(), cols.mean()
    h, w = mask.shape
    yy, xx = np.mgrid[:h, :w]
    disk = (yy - cr) ** 2 + (xx - cc) ** 2 <= int(0.1 * min(h, w)) ** 2
    gray = image.astype(np.float64).mean(axis=2)[disk]
    if not gray.size:
        return (cr, cc), {"mean_brightness": 0.0, "brightness_std": 0.0}
    return (cr, cc), {"mean_brightness": gray.mean(), "brightness_std": gray.std()}


@functools.lru_cache(maxsize=None)
def _jax_metrics(h: int, w: int, hull_mode: str):
    image, mask = _frames()[(h, w)]
    return jmetrics.calculate_metrics(image, mask, hull_mode)


@pytest.mark.parametrize("hull_mode", ["polygon", "reference"])
@pytest.mark.parametrize("h,w", FRAMES)
def test_calculate_metrics_whole_frames(h, w, hull_mode):
    """The single-cell API on whole frames: the 14 keys that do not depend on
    the centroid against JAX (integers equal, floats within 1e-5 relative);
    the centroid and the brightness against the float64 oracle within 1e-4
    relative (the fp32 disk sums), which JAX's fp32 centroid misses on some
    of these frames by up to a few percent."""
    image, mask = _frames()[(h, w)]
    got = tmetrics.calculate_metrics(image, mask, hull_mode, device="cpu")
    want = _jax_metrics(h, w, hull_mode)
    assert list(got) == list(want)
    for key in tmetrics.METRIC_KEYS:
        assert type(got[key]) is type(want[key]), key
        if key in CENTROID_KEYS:
            continue
        if isinstance(want[key], int):
            assert got[key] == want[key], key
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-5, abs=1e-6), key
    (cr, cc), exact = _oracle(image, mask)
    _, got_r, got_c = tmetrics._area_centroid(torch.from_numpy(mask[None]),
                                              torch.zeros((1, 2)))
    assert float(got_r) == pytest.approx(cr, rel=1e-4) and float(got_c) == pytest.approx(cc, rel=1e-4)
    for key in CENTROID_KEYS:
        assert got[key] == pytest.approx(exact[key], rel=1e-4), key
    no_hull = tmetrics.calculate_metrics_no_convex_hull(image, mask, device="cpu")
    assert {k: no_hull[k] for k in CENTROID_KEYS} == {k: got[k] for k in CENTROID_KEYS}


def test_whole_frame_brightness_is_exact_where_jax_rounds():
    """F13: on the 48 x 2048 frame JAX's fp32 moments put the centroid a
    rounding off column 1024, so pixels on the disk's circle fall out and its
    brightness std misses the oracle; the port's exact sums give the
    oracle's."""
    image, mask = _frames()[(48, 2048)]
    (cr, cc), exact = _oracle(image, mask)
    assert (cr, cc) == (24.0, 1024.0)
    want = exact["brightness_std"]
    jax_std = _jax_metrics(48, 2048, "polygon")["brightness_std"]
    assert abs(jax_std - want) > 1e-2 * want, (jax_std, want)
    got = tmetrics.calculate_metrics(image, mask, device="cpu")
    assert got["brightness_std"] == pytest.approx(want, rel=1e-5)
    assert got["mean_brightness"] == pytest.approx(exact["mean_brightness"], rel=1e-5)


@pytest.mark.parametrize("kind", ["full 4100 x 4100", "random 3000 x 5000", "band"])
def test_area_and_centroid_are_exact_on_whole_frames(kind):
    """Whole-frame masks whose fp32 moment sums round on the CPU (the fp32
    formula puts these centroids an ulp or more off): the area and the
    centroid equal the exact count and the float64 mean rounded to fp32, bit
    for bit (both are the int64 sums' fp64 quotient, rounded once)."""
    if kind == "full 4100 x 4100":  # 16.8 M pixels, above 2^24
        mask = np.ones((4100, 4100), bool)
    elif kind == "random 3000 x 5000":
        mask = np.random.default_rng(5).random((3000, 5000)) < 0.5
    else:  # a 2000 x 3000 block off the frame's centre
        mask = np.pad(np.ones((2000, 3000), bool), ((5, 1000), (7, 2000)))
    rows, cols = np.nonzero(mask)
    area, cr, cc = tmetrics._area_centroid(torch.from_numpy(mask[None]), torch.zeros((1, 2)))
    assert area.dtype == cr.dtype == cc.dtype == torch.float32
    assert (float(area), float(cr), float(cc)) == (
        np.float32(len(rows)), np.float32(rows.mean()), np.float32(cols.mean()))


def _area_centroid_fp32(on, off):
    """The fp32 formula the exact sums replaced: masked sums of the pixel
    count and of the row and column indices, an fp32 quotient, the offset."""
    m = on.float()
    _, h, w = m.shape
    rows = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    area = m.sum(dim=(1, 2))
    safe = area.clamp(min=1.0)
    return area, (m * rows).sum(dim=(1, 2)) / safe + off[:, 0], \
        (m * cols).sum(dim=(1, 2)) / safe + off[:, 1]


def test_crop_metrics_equal_the_fp32_formula_bit_for_bit(monkeypatch):
    """On 128 x 128 crops every fp32 partial sum is an exact integer and the
    fp64 quotient rounds to the fp32 one, so the exact sums change no bit:
    the area and centroid, and all 16 outputs of ``cell_metrics``, equal
    what the fp32 formula gives (random blobs, full and empty crops, offsets
    into a 512 x 640 frame)."""
    rng = np.random.default_rng(4)
    n = 24
    yy, xx = np.mgrid[:128, :128]
    cy, cx, ry, rx = (rng.uniform(lo, hi, (n, 1, 1))
                      for lo, hi in ((0, 128), (0, 128), (2, 90), (2, 90)))
    masks = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    masks &= rng.random(masks.shape) < 0.9  # holes: sums off the ellipse's symmetry
    masks[0], masks[1] = True, False
    on = torch.from_numpy(masks)
    off = torch.from_numpy(rng.integers(0, 384, (n, 2)))
    gray = torch.from_numpy(rng.uniform(0, 255, (3, 512, 640)).astype(np.float32))
    img_idx = torch.from_numpy(rng.integers(0, 3, n))
    for got, want in zip(tmetrics._area_centroid(on, off.float()),
                         _area_centroid_fp32(on, off.float())):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    got = tmetrics.cell_metrics(on, gray, img_idx, off, (512, 640))
    monkeypatch.setattr(tmetrics, "_area_centroid", _area_centroid_fp32)
    want = tmetrics.cell_metrics(on, gray, img_idx, off, (512, 640))
    for key in tmetrics.METRIC_KEYS:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
