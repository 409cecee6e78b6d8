"""The port's classical pipeline against the JAX package's, on the CPU:
``ops/morphology.py``, ``classical/pipeline.py``, ``classical/viz.py`` and
the project runner ``apps/opencv_project_inference.py``.

Mirrors ``tests/test_classical.py`` and ``tests/test_classical_viz.py``, and
holds each port function against its JAX counterpart on the same seeded
numpy input. Tolerances: masks, labels, crops and integer columns exact;
blur and contrast 1e-5 absolute; the rows' floats 1e-5 relative; the
runner's three CSVs byte-equal to the JAX runner's. Morphology oracles are
cv2's ``dilate`` / ``erode`` / ``GaussianBlur`` with cv2's default borders,
on a fixed ``np.random.default_rng`` seed of their own.
"""

import csv
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from yolo_sam_inference_tpu.apps import opencv_project_inference as japp
from yolo_sam_inference_tpu.classical import pipeline as jpipe
from yolo_sam_inference_tpu.classical import viz as jviz
from yolo_sam_inference_tpu.ops import metrics as jmetrics
from yolo_sam_inference_tpu.ops import morphology as jm
from yolo_sam_inference_tpu_torch.apps import opencv_project_inference as tapp
from yolo_sam_inference_tpu_torch.bench.common import write_png
from yolo_sam_inference_tpu_torch.classical import viz as tviz
from yolo_sam_inference_tpu_torch.classical.pipeline import (
    ClassicalParams,
    ClassicalPipeline,
    _bbox_intersects_roi,
)
from yolo_sam_inference_tpu_torch.io.png_native import decode_png
from yolo_sam_inference_tpu_torch.ops import morphology as tm
from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pipe(**params):
    return ClassicalPipeline(ClassicalParams(**params), device="cpu")


# ------------------------------------------------- mirrors of test_classical


def test_dilate_erode_vs_scipy():
    """cv2's borders: outside the frame is background for dilation and
    foreground for erosion (scipy's border_value 0 and 1)."""
    from scipy import ndimage

    mask = np.random.default_rng(11).random((40, 50)) > 0.3
    st = np.ones((3, 3), dtype=bool)
    np.testing.assert_array_equal(tm.dilate(_t(mask), 3, 1).numpy(),
                                  ndimage.binary_dilation(mask, st))
    np.testing.assert_array_equal(tm.erode(_t(mask), 3, 1).numpy(),
                                  ndimage.binary_erosion(mask, st, border_value=1))


def test_open_close_idempotent_on_big_blob():
    mask = np.zeros((32, 32), dtype=bool)
    mask[8:24, 8:24] = True
    np.testing.assert_array_equal(tm.morph_open(_t(mask), 3, 1).numpy(), mask)
    np.testing.assert_array_equal(tm.morph_close(_t(mask), 3, 1).numpy(), mask)


def test_open_removes_speckle():
    mask = np.zeros((32, 32), dtype=bool)
    mask[5, 5] = True
    mask[10:20, 10:20] = True
    opened = tm.morph_open(_t(mask), 3, 1).numpy()
    assert not opened[5, 5]
    assert opened[12:18, 12:18].all()


@pytest.mark.parametrize("shape", [(48, 64), (3, 48, 64)])
@pytest.mark.parametrize("sigma", [0.0, 1.2])
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_gaussian_blur_vs_cv2(ksize, sigma, shape):
    """cv2's BORDER_REFLECT_101 and taps. At sigma 0 the JAX module (and so
    the port) derives sigma from ksize by cv2's formula, where cv2 itself
    takes a fixed table for ksize <= 7: cv2 is given that sigma."""
    img = (np.random.default_rng(12).random(shape) * 255).astype(np.float32)
    got = tm.gaussian_blur(_t(img), ksize, sigma).numpy()
    planes = img.reshape(-1, *shape[-2:])
    cv_sigma = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    want = np.stack([cv2.GaussianBlur(p, (ksize, ksize), cv_sigma) for p in planes])
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-4, atol=1e-3)


def test_subtract_and_threshold_semantics():
    a = torch.tensor([[10.0, 5.0]])
    b = torch.tensor([[3.0, 9.0]])
    np.testing.assert_array_equal(tm.subtract_clip(a, b).numpy(), [[7.0, 0.0]])
    np.testing.assert_array_equal(tm.absdiff(a, b).numpy(), [[7.0, 4.0]])
    np.testing.assert_array_equal(tm.threshold_binary(torch.tensor([[5.0, 6.0]]), 5.0).numpy(),
                                  [[False, True]])


@pytest.fixture
def synthetic_frames():
    rng = np.random.default_rng(13)
    h, w, n = 96, 128, 3
    bg = rng.normal(40, 2, size=(h, w)).astype(np.float32).clip(0, 255)
    frames = np.stack([bg.copy() for _ in range(n)])
    yy, xx = np.mgrid[:h, :w]
    centers = [(30, 40), (60, 90), (50, 30)]
    for i in range(n):
        cy, cx = centers[i]
        frames[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= 8**2] = 200.0
    return frames, bg, centers


def test_classical_end_to_end(synthetic_frames):
    frames, bg, centers = synthetic_frames
    results = _pipe(threshold=20, min_area=30).process_images(frames, background=bg)
    assert len(results) == 3
    for i, rows in enumerate(results):
        assert len(rows) == 1, f"frame {i}: expected 1 cell, got {len(rows)}"
        row = rows[0]
        cy, cx = centers[i]
        assert abs((row["min_x"] + row["max_x"]) / 2 - cy) < 4
        assert abs((row["min_y"] + row["max_y"]) / 2 - cx) < 4
        assert row["circularity"] == 0.5 and row["deformability"] == 0.5
        assert row["area_ratio"] == 1.0
        assert row["area"] > 100


def test_classical_roi_filter(synthetic_frames):
    frames, bg, _ = synthetic_frames
    roi = {"x_min": 80, "x_max": 120, "y_min": 0, "y_max": 1000}
    results = _pipe(threshold=20, min_area=30).process_images(frames, background=bg, roi=roi)
    assert [len(r) for r in results] == [0, 1, 0]


def test_bbox_roi_intersection_convention():
    row = {"min_x": 10, "max_x": 20, "min_y": 30, "max_y": 40}
    for roi in ({"x_min": 35, "x_max": 50}, {"x_min": 45, "x_max": 50},
                {"x_min": 0, "x_max": 100, "y_min": 15, "y_max": 18},
                {"x_min": 0, "x_max": 100, "y_min": 25, "y_max": 28}):
        assert _bbox_intersects_roi(row, roi) == jpipe._bbox_intersects_roi(row, roi)
    assert _bbox_intersects_roi(row, {"x_min": 35, "x_max": 50})
    assert not _bbox_intersects_roi(row, {"x_min": 45, "x_max": 50})


def test_parameters_snapshot(tmp_path):
    pipe = _pipe(threshold=15)
    pipe.save_parameters(tmp_path / "t.json")
    jpipe.ClassicalPipeline(jpipe.ClassicalParams(threshold=15)).save_parameters(
        tmp_path / "j.json")
    data = json.loads((tmp_path / "t.json").read_text())
    assert data["threshold"] == 15
    assert data["pipeline"] == "classical_background_subtraction"
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


# ------------------------------------------------------- against cv2 and JAX


@pytest.mark.parametrize("shape", [(37, 53), (3, 37, 53)])
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_dilate_erode_vs_cv2(iterations, shape):
    mask = np.random.default_rng(14).random(shape) > 0.4
    kernel = np.ones((3, 3), np.uint8)
    planes = mask.reshape(-1, *shape[-2:]).astype(np.uint8)
    for fn, ref in ((tm.dilate, cv2.dilate), (tm.erode, cv2.erode)):
        want = np.stack([ref(p, kernel, iterations=iterations) for p in planes]) > 0
        np.testing.assert_array_equal(fn(_t(mask), 3, iterations).numpy(),
                                      want.reshape(shape), err_msg=fn.__name__)


@pytest.mark.parametrize("fn", ["dilate", "erode", "morph_open", "morph_close"])
def test_binary_morphology_matches_jax(fn):
    mask = np.random.default_rng(15).random((2, 41, 57)) > 0.45
    for it in (1, 2, 3):
        np.testing.assert_array_equal(getattr(tm, fn)(_t(mask), 3, it).numpy(),
                                      np.asarray(getattr(jm, fn)(jnp.asarray(mask), 3, it)))


def test_filters_match_jax():
    """Blur and contrast within 1e-5 abs; the elementwise ops exact."""
    rng = np.random.default_rng(16)
    a = (rng.random((2, 40, 52)) * 255).astype(np.float32)
    b = (rng.random((40, 52)) * 255).astype(np.float32)
    for ks, sg in ((3, 0.0), (5, 0.0), (5, 1.2), (7, 0.0)):
        np.testing.assert_allclose(tm.gaussian_blur(_t(a), ks, sg).numpy(),
                                   np.asarray(jm.gaussian_blur(jnp.asarray(a), ks, sg)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.contrast(_t(a), 1.2, 3.0).numpy(),
                               np.asarray(jm.contrast(jnp.asarray(a), 1.2, 3.0)),
                               rtol=0, atol=1e-5)
    for fn in ("subtract_clip", "absdiff"):
        np.testing.assert_array_equal(getattr(tm, fn)(_t(a), _t(b)[None]).numpy(),
                                      np.asarray(getattr(jm, fn)(jnp.asarray(a),
                                                                 jnp.asarray(b)[None])))
    np.testing.assert_array_equal(tm.threshold_binary(_t(a), 100.0).numpy(),
                                  np.asarray(jm.threshold_binary(jnp.asarray(a), 100.0)))


def _ellipse_frames(seed, n, h, w, cells=(3, 8), background=30.0):
    """uint8 frames: a background near ``background`` (sigma 1) with 3-8
    filled ellipses of 200 each; and the background frame itself."""
    rng = np.random.default_rng(seed)
    bg = rng.normal(background, 1, size=(h, w)).clip(0, 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    frames = []
    for _ in range(n):
        f = bg.copy()
        for _ in range(rng.integers(*cells, endpoint=True)):
            cy, cx = rng.uniform(4, h - 4), rng.uniform(4, w - 4)
            ry, rx = rng.uniform(3, 9), rng.uniform(3, 9)
            f[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = 200
        frames.append(f)
    return np.stack(frames), bg


def test_classical_detect_batch_matches_jax():
    frames, bg = _ellipse_frames(17, 4, 72, 96)
    blurred = tm.gaussian_blur(_t(bg.astype(np.float32)), 5, 0.0)
    for thr, dil, ero in ((10.0, 2, 2), (20.0, 1, 3)):
        got = tm.classical_detect_batch(_t(frames), blurred, threshold=thr,
                                        dilate_iterations=dil, erode_iterations=ero).numpy()
        want = np.asarray(jm.classical_detect_batch(
            jnp.asarray(frames.astype(np.float32)), jnp.asarray(blurred.numpy()),
            threshold=thr, dilate_iterations=dil, erode_iterations=ero))
        np.testing.assert_array_equal(got, want)
        assert 0 < got.mean() < 0.5


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k in INT_METRIC_KEYS or isinstance(w[k], int):
                assert g[k] == w[k], k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("rgb", [False, True])
def test_process_images_matches_jax(rgb):
    """Rows (ints exact, floats 1e-5) and both masks equal the JAX
    pipeline's; RGB frames are averaged on the host in both."""
    frames, bg = _ellipse_frames(18, 5, 80, 112)
    if rgb:
        frames = np.repeat(frames[..., None], 3, axis=-1)
    roi = {"x_min": 20, "x_max": 90, "y_min": 5, "y_max": 70}
    params = dict(threshold=15, min_area=20, metric_crop=48)
    got = _pipe(**params).process_images(frames, background=bg, roi=roi, return_masks=True)
    want = jpipe.ClassicalPipeline(jpipe.ClassicalParams(**params)).process_images(
        frames, background=bg, roi=roi, return_masks=True)
    for b in range(len(frames)):
        _rows_equal(got[0][b], want[0][b])
    assert sum(map(len, got[0])) >= 5
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_components_match_jax():
    """Labels and crops exact: the same components, crops and offsets."""
    frames, bg = _ellipse_frames(19, 2, 64, 80)
    port, jax_ = _pipe(min_area=10, metric_crop=32), jpipe.ClassicalPipeline(
        jpipe.ClassicalParams(min_area=10, metric_crop=32))
    port.preprocess_background(bg)
    masks = port.detect_masks_batch(frames)
    for m in masks:
        got, want = port.extract_components(m), jax_.extract_components(m)
        assert len(got) == len(want) > 0
        for (gc, go), (wc, wo) in zip(got, want):
            assert go == wo
            np.testing.assert_array_equal(gc, wc)


def test_one_metrics_call_a_batch_equals_one_a_frame(monkeypatch):
    """The port's single ``cell_metrics`` call over the batch gives the rows
    the JAX package's per-frame ``batched_cell_metrics`` calls give."""
    from yolo_sam_inference_tpu_torch.classical import pipeline as tpipe

    frames, bg = _ellipse_frames(20, 4, 64, 96)
    pipe = _pipe(threshold=15, min_area=15, metric_crop=40)
    calls = []
    real = tpipe.cell_metrics
    monkeypatch.setattr(tpipe, "cell_metrics",
                        lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
    pipe.preprocess_background(bg)
    gray = torch.from_numpy(frames).float()
    comps = [pipe.extract_components(m) for m in pipe.detect_masks_batch(frames)]
    table = pipe.batch_metrics(comps, gray)
    assert len(calls) == 1 and calls[0] == sum(map(len, comps)) == table.shape[0]
    n = 0
    for b, frame in enumerate(comps):
        if not frame:
            continue
        want = jmetrics.batched_cell_metrics(
            jnp.asarray(np.stack([c for c, _ in frame])), jnp.asarray(frames[b].astype(np.float32)),
            offsets=jnp.asarray(np.asarray([o for _, o in frame], np.int32)),
            image_shape=frames.shape[1:])
        want = np.stack([np.asarray(want[k]) for k in METRIC_KEYS], axis=1)
        np.testing.assert_allclose(table[n:n + len(frame)], want, rtol=1e-5, atol=1e-4)
        n += len(frame)


def test_uint8_upload_equals_float_frames():
    frames, bg = _ellipse_frames(21, 2, 48, 64)
    pipe = _pipe(threshold=15, min_area=15)
    a = pipe.process_images(frames, background=bg)
    b = pipe.process_images(frames.astype(np.float32), background=bg)
    assert a == b


def test_pipeline_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClassicalPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--project-dir", ".", "--output-dir", "o"])


# --------------------------------------------- mirrors of test_classical_viz


def _frame_with_blob(h=80, w=100, cy=40, cx=30, r=10):
    bg = np.full((h, w), 30.0, dtype=np.float32)
    yy, xx = np.mgrid[:h, :w]
    f = bg.copy()
    f[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 200.0
    return f, bg


def test_return_masks_shapes_and_subset():
    f, bg = _frame_with_blob()
    results, masks, filtered = _pipe(threshold=20, min_area=30).process_images(
        f[None], background=bg, return_masks=True)
    assert masks.shape == (1, 80, 100) and masks.dtype == bool
    assert filtered.shape == masks.shape and filtered.dtype == bool
    assert not (filtered & ~masks).any()
    assert filtered.any() and len(results[0]) == 1


def test_roi_filter_empties_filtered_mask():
    f, bg = _frame_with_blob(cx=30)
    results, masks, filtered = _pipe(threshold=20, min_area=30).process_images(
        f[None], background=bg, roi={"x_min": 80, "x_max": 99}, return_masks=True)
    assert masks.any()
    assert not filtered.any() and results[0] == []


def _read_png(path):
    return decode_png(Path(path).read_bytes())


def test_save_visualization_layout(tmp_path):
    """The mirror's checks, and the decoded pixels equal the JAX writer's."""
    from PIL import Image

    f, _ = _frame_with_blob()
    mask = np.zeros((80, 100), bool)
    mask[30:50, 20:40] = True
    filtered = np.zeros_like(mask)
    filtered[35:45, 25:35] = True
    roi = {"x_min": 5, "x_max": 90, "y_min": 5, "y_max": 70}
    metrics = [{"deformability": 0.25}, {"deformability": 0.35}]
    tviz.save_visualization(f, mask, filtered, roi, tmp_path / "v.png", metrics)
    jviz.save_visualization(f, mask, filtered, roi, tmp_path / "j.png", metrics)
    im = _read_png(tmp_path / "v.png")
    assert im.shape == (80, 200, 3)
    lp = im[40, 30]
    assert lp[0] > lp[2] and lp[0] > lp[1]
    rp = im[40, 100 + 30]
    assert rp[2] > rp[0]
    assert (im[5, 5] == [0, 255, 0]).all() and (im[5, 105] == [0, 255, 0]).all()
    np.testing.assert_array_equal(im, np.asarray(Image.open(tmp_path / "j.png")))


def test_save_visualization_without_pil(tmp_path, monkeypatch):
    """Without PIL the rectangle is drawn in numpy, pixel for pixel as
    ImageDraw draws it; only the text is missing."""
    from PIL import Image, ImageDraw

    f, _ = _frame_with_blob()
    mask = np.zeros((80, 100), bool)
    mask[30:50, 20:40] = True
    roi = {"x_min": 5, "x_max": 90, "y_min": 50, "y_max": 70}
    monkeypatch.setattr(tviz, "_PILImage", None)
    tviz.save_visualization(f, mask, mask, roi, tmp_path / "v.png")
    rgb = tviz._to_rgb(f)
    want = Image.fromarray(np.concatenate([tviz._overlay(rgb, mask, tviz._RED),
                                           tviz._overlay(rgb, mask, tviz._BLUE)], axis=1))
    draw = ImageDraw.Draw(want)
    for off in (0, 100):
        draw.rectangle([off + 5, 50, off + 90, 70], outline=(0, 255, 0), width=2)
    np.testing.assert_array_equal(_read_png(tmp_path / "v.png"), np.asarray(want))


def test_save_mask_pngs(tmp_path):
    from PIL import Image

    mask = np.zeros((16, 16), bool)
    mask[4:8, 4:8] = True
    filt = np.zeros_like(mask)
    mp, fp = tviz.save_mask_pngs(mask, filt, tmp_path, "b1_img")
    assert mp.name == "b1_img_mask.png" and fp.name == "b1_img_filtered_mask.png"
    m = _read_png(mp)
    assert m.max() == 255 and (m > 0).sum() == 16
    assert _read_png(fp).max() == 0
    jm_, jf = jviz.save_mask_pngs(mask, filt, tmp_path / "j", "b1_img")
    np.testing.assert_array_equal(m, np.asarray(Image.open(jm_)))


def test_disambiguated_name():
    p = Path("/proj/cond/batch_3_output/cropped_roi_with_target/frame.png")
    assert tviz.disambiguated_name(p) == "batch_3_output_frame"
    q = Path("/proj/cond/outputs/frames/frame.png")
    name = tviz.disambiguated_name(q)
    assert name.endswith("_frame") and len(name.split("_")[0]) == 6
    r = Path("/proj/cond/other/frames/frame.png")
    assert tviz.disambiguated_name(r) != name
    for path in (p, q, r):
        assert tviz.disambiguated_name(path) == jviz.disambiguated_name(path)


def test_disambiguated_name_direct_batch_layout():
    a = Path("/proj/cond_1/a_output/frame.png")
    b = Path("/proj/cond_1/b_output/frame.png")
    assert tviz.disambiguated_name(a) != tviz.disambiguated_name(b)
    c = Path("/proj/cond/a_output/frame.png")
    d = Path("/proj/cond/b_output/frame.png")
    assert tviz.disambiguated_name(c) != tviz.disambiguated_name(d)
    for path in (a, b, c, d):
        assert tviz.disambiguated_name(path) == jviz.disambiguated_name(path)


@pytest.fixture
def classical_project(tmp_path):
    """cond_a/batch_1_output/cropped_roi_with_target/*.png (the mirror's
    layout), written by the port's PNG writer."""
    rng = np.random.default_rng(22)
    d = tmp_path / "proj" / "cond_a" / "batch_1_output" / "cropped_roi_with_target"
    d.mkdir(parents=True)
    bg = rng.normal(30, 1, size=(80, 100)).clip(0, 255).astype(np.uint8)
    write_png(d / "background.png", bg)
    yy, xx = np.mgrid[:80, :100]
    for i in range(3):
        f = bg.astype(np.float32).copy()
        f[(yy - 40) ** 2 + (xx - (30 + 10 * i)) ** 2 <= 100] = 200
        write_png(d / f"frame_{i}.png", f.astype(np.uint8))
    return tmp_path / "proj"


def _argv(project, out, *extra):
    return ["--project-dir", str(project), "--output-dir", str(out), "--thresholds", "20",
            "--min-area", "30", *extra]


def test_runner_writes_visualizations(classical_project, tmp_path):
    out = tmp_path / "out"
    assert tapp.main(_argv(classical_project, out, "--device", "cpu")) == 0
    runs = list(out.iterdir())
    assert len(runs) == 1
    run = runs[0]
    assert (run / "cell_metrics.csv").exists()
    vis = sorted((run / "cond_a").glob("*_visualization.png"))
    masks = sorted((run / "cond_a").glob("*_mask.png"))
    assert len(vis) == 3 and len(masks) == 6
    assert all(v.name.startswith("batch_1_output_") for v in vis)
    jout = tmp_path / "jout"
    assert japp.main(_argv(classical_project, jout)) == 0
    jrun = next(jout.iterdir())
    for png in vis + masks:
        from PIL import Image

        np.testing.assert_array_equal(_read_png(png), np.asarray(
            Image.open(jrun / "cond_a" / png.name)), err_msg=png.name)


def test_runner_no_visualizations_flag(classical_project, tmp_path):
    out = tmp_path / "out"
    assert tapp.main(_argv(classical_project, out, "--no-save-visualizations",
                           "--device", "cpu")) == 0
    run = next(out.iterdir())
    assert not list(run.glob("cond_a/*_visualization.png"))


def _two_condition_project(root: Path) -> Path:
    """cond_a: two ``*_output`` batches of ellipse frames; cond_b: one
    frame with a single cell in a flat folder (its std is empty)."""
    for c, cond in enumerate(("cond_a", "cond_b")):
        batches = ("b1_output", "b2_output") if c == 0 else (".",)
        for b, batch in enumerate(batches):
            frames, bg = _ellipse_frames(30 + 3 * c + b, 3 if c == 0 else 1, 64, 96,
                                         cells=(3, 6) if c == 0 else (1, 1))
            d = root / cond / batch / ("cropped_roi_with_target" if c == 0 else ".")
            d.mkdir(parents=True, exist_ok=True)
            write_png(d / "background.png", bg)
            for i, f in enumerate(frames):
                write_png(d / f"frame_{i}.png", f)
    return root


@pytest.mark.parametrize("roi", [None, "10,80", "10,80,5,50"])
def test_runner_csvs_equal_the_jax_runner(tmp_path, roi):
    """A sweep of two thresholds against the JAX runner on the same project:
    ``image_summary.csv``, ``deformability_summary.csv`` and the parameters
    byte-equal; ``cell_metrics.csv`` the same header, rows, strings and
    integer columns, its float columns within 1e-5 relative (the metrics'
    fp32 sums round in another order: brightness_std and perimeter differ in
    their last bits, not in formatting)."""
    project = _two_condition_project(tmp_path / "proj")
    extra = ["--thresholds", "10,20", "--min-area", "15", "--batch-size", "2",
             "--no-save-visualizations"] + (["--roi", roi] if roi else [])
    base = ["--project-dir", str(project)]
    assert tapp.main(base + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"] + extra) == 0
    assert japp.main(base + ["--output-dir", str(tmp_path / "j")] + extra) == 0
    truns = sorted((tmp_path / "t").iterdir(), key=lambda p: p.name.split("_thresh")[1])
    jruns = sorted((tmp_path / "j").iterdir(), key=lambda p: p.name.split("_thresh")[1])
    assert [p.name.split("_thresh")[1] for p in truns] == ["10", "20"]
    for trun, jrun in zip(truns, jruns):
        names = sorted(p.name for p in jrun.iterdir())
        assert sorted(p.name for p in trun.iterdir()) == names
        assert "deformability_summary.csv" in names
        for name in names:
            if name != "cell_metrics.csv":
                assert (trun / name).read_bytes() == (jrun / name).read_bytes(), (trun.name, name)
        got, want = (list(csv.reader(open(run / "cell_metrics.csv"))) for run in (trun, jrun))
        assert got[0] == want[0] and len(got) == len(want) > 10
        floats = [j for j, h in enumerate(want[0]) if h not in INT_METRIC_KEYS and h not in (
            "condition", "batch", "image_name", "cell_id")]
        for g, w in zip(got[1:], want[1:]):
            assert [v for j, v in enumerate(g) if j not in floats] == \
                [v for j, v in enumerate(w) if j not in floats]
            np.testing.assert_allclose([float(g[j]) for j in floats],
                                       [float(w[j]) for j in floats], rtol=1e-5, atol=1e-6)
    if roi is None:  # cond_b's one cell: an empty std
        summary = (truns[0] / "deformability_summary.csv").read_text().splitlines()
        assert summary[2].startswith("cond_b,1,") and summary[2].endswith(",")


def test_deformability_summary_is_pandas_groupby():
    """Kahan mean and Welford std (ddof 1) as pandas' groupby computes them,
    on values where the plain sum would round differently."""
    rng = np.random.default_rng(23)
    rows = [{"condition": c, "area": int(rng.integers(10, 900)),
             "deformability": float(rng.random() * 10.0 ** rng.integers(-3, 3))}
            for c in rng.choice(["b", "a", "c"], size=200)]
    rows.append({"condition": "d", "area": 5, "deformability": 0.1})
    want = (pd.DataFrame(rows).groupby("condition")
            .agg(num_cells=("area", "size"), mean_area=("area", "mean"),
                 mean_deformability=("deformability", "mean"),
                 std_deformability=("deformability", "std")).reset_index())
    got = tapp.deformability_summary(rows)
    assert [r["condition"] for r in got] == list(want["condition"])
    for col in ("num_cells", "mean_area", "mean_deformability"):
        assert [r[col] for r in got] == list(want[col]), col
    assert [r["std_deformability"] for r in got[:3]] == list(want["std_deformability"][:3])
    assert np.isnan(got[3]["std_deformability"])
