"""The port's images.bin classical pipeline (``classical/ms_process.py`` and
``apps/ms_opencv_process.py``) against the JAX package's, on the CPU.

Mirrors the four ``ms_process`` cases of ``tests/test_tools.py``, and holds
the port against the JAX functions on the same seeded streams: the masks of
``process_frame_batch`` exact, the background within 1e-5 abs,
``analyze_mask``'s rows equal (ring, multi-blob, border-touching and
holeless masks), and ``deformability_results.csv`` byte-equal to the JAX
runner's (the port writes it without pandas) on the ring project, an empty
project, a stream where no frame passes the gates, and a project of two
batches one of which yields nothing.
"""

import numpy as np
import pytest
import torch

from yolo_sam_inference_tpu.classical import ms_process as jms
from yolo_sam_inference_tpu_torch.apps import ms_opencv_process as tapp
from yolo_sam_inference_tpu_torch.bench.common import write_png
from yolo_sam_inference_tpu_torch.classical import ms_process as tms
from yolo_sam_inference_tpu_torch.io.images_bin import write_images_bin

torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

CFG = dict(threshold=30, min_area=100, max_area=2000)


def _ring_frames(bg, n=6, step=8, h=96, w=128):
    yy, xx = np.mgrid[:h, :w]
    frames = []
    for i in range(n):
        f = bg.copy().astype(np.float64)
        cy, cx = 48, 40 + i * step
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        f[(d2 <= 14**2) & (d2 >= 9**2)] = 220
        frames.append(f.astype(np.uint8))
    return frames


def _batch(root, name, frames, bg, roi=(0, 0, 128, 96)):
    batch = root / name
    batch.mkdir(parents=True)
    write_images_bin(batch / "images.bin", frames)
    with open(batch / "roi.csv", "w") as f:
        f.write("x,y,width,height\n" + ",".join(map(str, roi)) + "\n")
    write_png(batch / "background.png", bg)
    return batch


@pytest.fixture
def images_bin_project(tmp_path):
    """One batch dir: images.bin of 6 frames with one ring-shaped cell each
    (outer + inner contour), roi.csv and background.png."""
    bg = np.random.default_rng(50).normal(30, 1, size=(96, 128)).clip(0, 255).astype(np.uint8)
    _batch(tmp_path / "proj", "batch_1", _ring_frames(bg), bg)
    return tmp_path / "proj"


# ------------------------------------------------- mirrors of test_tools.py


def test_ms_process_end_to_end(images_bin_project, tmp_path):
    out = tmp_path / "msout"
    rows = tms.process_project(images_bin_project, out, tms.MsProcessingConfig(**CFG),
                               device="cpu")
    assert (out / "deformability_results.csv").exists()
    assert (out / "pipeline_parameters.json").exists()
    assert len(rows) >= 3
    assert all(r["circularity"] > 0.8 and r["deformability"] < 0.2 and r["area"] >= 100
               for r in rows)


def test_ms_process_cpp_exact_metric():
    mask = np.zeros((100, 100), dtype=np.uint8)
    cv2.circle(mask, (50, 50), 30, 1, -1)
    cnts, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    m = tms.contour_metrics(cnts[0])
    assert m["circularity"] == pytest.approx(0.95, abs=0.06)
    assert m["deformability"] == pytest.approx(0.05, abs=0.06)
    assert m == jms.contour_metrics(cnts[0])


def test_ms_process_debug_dumps(images_bin_project, tmp_path):
    """Sampled stage dumps land in <batch_dir>/debug, their pixels those of
    the JAX package's dumps."""
    from PIL import Image

    from yolo_sam_inference_tpu_torch.io.png_native import decode_png

    cfg = dict(CFG, debug_dumps=True, batch_size=4)
    tms.process_project(images_bin_project, tmp_path / "msout", tms.MsProcessingConfig(**cfg),
                        device="cpu")
    dbg = images_bin_project / "batch_1" / "debug"
    assert dbg.is_dir()
    port = {p.name: decode_png(p.read_bytes()) for p in dbg.iterdir()}
    for idx in (0, 4):
        for stage in ("original", "roi", "background", "processed"):
            assert f"image_{idx}_{stage}.png" in port, (idx, stage)
    assert "image_5_original.png" not in port
    for p in dbg.iterdir():
        p.unlink()
    jms.process_project(images_bin_project, tmp_path / "jout", jms.MsProcessingConfig(**cfg))
    assert sorted(port) == sorted(p.name for p in dbg.iterdir())
    for name, img in port.items():
        np.testing.assert_array_equal(img, np.asarray(Image.open(dbg / name)), err_msg=name)


def test_ms_process_no_debug_dumps_by_default(images_bin_project, tmp_path):
    tms.process_project(images_bin_project, tmp_path / "msout", tms.MsProcessingConfig(**CFG),
                        device="cpu")
    assert not (images_bin_project / "batch_1" / "debug").exists()


# --------------------------------------------------------- against the JAX


def test_read_roi_csv_matches_jax(tmp_path):
    p = tmp_path / "roi.csv"
    p.write_text("x,y,width,height\n3,4.0,50,60\n7,8,9,10\n")
    assert tms.read_roi_csv(p) == jms.read_roi_csv(p) == {"x": 3, "y": 4, "width": 50,
                                                          "height": 60}
    assert tms.read_roi_csv(tmp_path / "none.csv") is None


def test_background_and_masks_match_jax():
    """The background within 1e-5 abs; process_frame_batch's masks exact,
    at the default config and at a sharper one."""
    rng = np.random.default_rng(51)
    bg = rng.normal(30, 1, size=(96, 128)).clip(0, 255).astype(np.uint8)
    frames = np.stack(_ring_frames(bg, n=5)) + rng.integers(0, 3, (5, 96, 128)).astype(np.uint8)
    for cfg in (tms.MsProcessingConfig(**CFG),
                tms.MsProcessingConfig(threshold=8, blur_kernel=5, close_iterations=2,
                                       open_iterations=2, contrast_alpha=1.5,
                                       contrast_beta=-4.0)):
        jcfg = jms.MsProcessingConfig(**cfg.to_json())
        tb = tms.preprocess_background(bg, cfg, device="cpu")
        jb = jms.preprocess_background(bg, jcfg)
        np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-5)
        got = tms.process_frame_batch(frames, tb, cfg)
        want = jms.process_frame_batch(frames, jb, jcfg)
        np.testing.assert_array_equal(got, want)
        assert got.any() and got.dtype == bool


def _disk(mask, cy, cx, r, value=1):
    yy, xx = np.mgrid[:mask.shape[0], :mask.shape[1]]
    mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = value


def _masks():
    ring = np.zeros((96, 128), np.uint8)
    _disk(ring, 48, 60, 14)
    _disk(ring, 48, 60, 9, 0)
    multi = ring.copy()
    _disk(multi, 20, 20, 6)
    border = np.zeros((96, 128), np.uint8)
    _disk(border, 48, 6, 14)
    _disk(border, 48, 6, 8, 0)
    holeless = np.zeros((96, 128), np.uint8)
    _disk(holeless, 50, 64, 15)
    two_holes = np.zeros((96, 128), np.uint8)
    _disk(two_holes, 48, 64, 20)
    _disk(two_holes, 48, 56, 5, 0)
    _disk(two_holes, 48, 72, 5, 0)
    return {"ring": ring, "multi": multi, "border": border, "holeless": holeless,
            "two_holes": two_holes, "empty": np.zeros((96, 128), np.uint8)}


@pytest.mark.parametrize("single_inner", [True, False])
@pytest.mark.parametrize("name", ["ring", "multi", "border", "holeless", "two_holes", "empty"])
def test_analyze_mask_matches_jax(name, single_inner):
    mask = _masks()[name].astype(bool)
    cfg = dict(min_area=100, max_area=2000, require_single_inner=single_inner)
    got = tms.analyze_mask(mask, tms.MsProcessingConfig(**cfg))
    want = jms.analyze_mask(mask, jms.MsProcessingConfig(**cfg))
    assert got == want
    if name == "ring":
        assert got is not None and "area_ratio" in got
    if name == "holeless":
        assert (got is None) == single_inner


def _both(project, tmp_path, **cfg):
    cfg = dict(CFG, **cfg)
    trows = tms.process_project(project, tmp_path / "t", tms.MsProcessingConfig(**cfg),
                                device="cpu")
    jdf = jms.process_project(project, tmp_path / "j", jms.MsProcessingConfig(**cfg))
    for name in ("deformability_results.csv", "pipeline_parameters.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    return trows, jdf


def test_project_csv_equals_jax(images_bin_project, tmp_path):
    trows, jdf = _both(images_bin_project, tmp_path)
    assert len(trows) == len(jdf) >= 3


@pytest.mark.parametrize("empty_first", [False, True])
def test_project_csv_of_two_batches_one_empty(tmp_path, empty_first):
    """A batch whose frames all fail the gates (no background file: the
    first frame is one) beside the ring batch, before or after it: its
    missing columns turn frame_index to floats, and first it puts ``batch``
    first, as pandas' concat does."""
    rng = np.random.default_rng(52)
    bg = rng.normal(30, 1, size=(96, 128)).clip(0, 255).astype(np.uint8)
    full, none = ("b_batch", "a_batch") if empty_first else ("a_batch", "b_batch")
    _batch(tmp_path / "proj", full, _ring_frames(bg, n=5), bg)
    empty = _batch(tmp_path / "proj", none, [bg] * 3, bg)
    (empty / "background.png").unlink()
    trows, jdf = _both(tmp_path / "proj", tmp_path, batch_size=2, require_single_inner=False)
    assert len(trows) == len(jdf) > 0
    assert {r["batch"] for r in trows} == {full}
    header = (tmp_path / "t" / "deformability_results.csv").read_text().split(",", 1)[0]
    assert header == ("batch" if empty_first else "frame_index")


def test_first_frame_background_is_cropped_once(tmp_path):
    """No background and an ROI: the port crops the first frame once, as
    the JAX function does when given that frame; the JAX function's own
    fallback crops the cropped frame again and fails on the shapes."""
    rng = np.random.default_rng(54)
    bg = rng.normal(30, 1, size=(96, 128)).clip(0, 255).astype(np.uint8)
    frames = [bg] + _ring_frames(bg, n=4)
    write_images_bin(tmp_path / "images.bin", frames)
    roi = {"x": 8, "y": 4, "width": 112, "height": 88}
    cfg = dict(CFG, batch_size=2)
    got = tms.process_stream(tmp_path / "images.bin", tms.MsProcessingConfig(**cfg), None, roi,
                             device="cpu")
    want = jms.process_stream(tmp_path / "images.bin", jms.MsProcessingConfig(**cfg),
                              frames[0], roi)
    assert got == want.to_dict("records") and len(got) == 4
    with pytest.raises(Exception):
        jms.process_stream(tmp_path / "images.bin", jms.MsProcessingConfig(**cfg), None, roi)


def test_project_csv_where_no_frame_passes(tmp_path):
    bg = np.random.default_rng(53).normal(30, 1, size=(96, 128)).clip(0, 255).astype(np.uint8)
    _batch(tmp_path / "proj", "batch_1", [bg] * 4, bg)
    trows, _ = _both(tmp_path / "proj", tmp_path)
    assert trows == []
    assert (tmp_path / "t" / "deformability_results.csv").read_text() == "batch\n"


def test_empty_project_writes_the_header(tmp_path):
    (tmp_path / "proj").mkdir()
    trows, _ = _both(tmp_path / "proj", tmp_path)
    assert trows == []
    assert (tmp_path / "t" / "deformability_results.csv").read_text() == \
        "frame_index,area,perimeter,circularity,deformability,batch\n"


def test_cli_matches_jax_cli(images_bin_project, tmp_path, capsys):
    from yolo_sam_inference_tpu.apps import ms_opencv_process as japp

    argv = ["--project-dir", str(images_bin_project), "--threshold", "30", "--min-area", "100",
            "--max-area", "2000", "--batch-size", "4"]
    assert tapp.main(argv + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert japp.main(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    assert (tmp_path / "t" / "deformability_results.csv").read_bytes() == \
        (tmp_path / "j" / "deformability_results.csv").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" valid cells")[0] == out[1].split(" valid cells")[0]
    assert tapp.main(["--project-dir", str(tmp_path / "none"), "--output-dir", "o"]) == 2


def test_refuses_without_a_card_or_cv2(images_bin_project, tmp_path, monkeypatch):
    """The card is the default: without one the runner raises. Without cv2,
    process_stream raises at its entry, naming cv2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--project-dir", str(images_bin_project), "--output-dir",
                   str(tmp_path / "o")])
    monkeypatch.setattr(tms, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        tms.process_stream(images_bin_project / "batch_1" / "images.bin",
                           tms.MsProcessingConfig(), device="cpu")
