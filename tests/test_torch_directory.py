"""The port's disk-to-CSV path against the JAX package's, on the CPU.

The directory path (``process_directory`` with its overlapped batches, the
device bitpack, ``fused_call_chunked``), the loader and image I/O without
PIL, the reporting writers, the flat-folder runner and the bench entry. Both
``CellSegmentationPipeline``s at a tiny size, fp32, from one seed:
``sam_tiny_test()``, YOLOv8n at a 64-pixel letterbox, 64x64 ``tests/synth.py``
frames written as PNG files.
"""

import io
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu import reporting as jreporting
from yolo_sam_inference_tpu.io import tiff as jtiff
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu.pipeline import loader as jloader
from yolo_sam_inference_tpu.pipeline import results as jresults
from yolo_sam_inference_tpu.utils import image_utils as jimage_utils
from yolo_sam_inference_tpu_torch import reporting as treporting
from yolo_sam_inference_tpu_torch.bench import e2e
from yolo_sam_inference_tpu_torch.bench.common import png_bytes, write_png
from yolo_sam_inference_tpu_torch.io import tiff as ttiff
from yolo_sam_inference_tpu_torch.io.png_native import decode_png
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.pipeline import loader as tloader
from yolo_sam_inference_tpu_torch.pipeline import results as tresults
from yolo_sam_inference_tpu_torch.utils import image_utils as timage_utils

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64)
MASKS = "3_processed_masks/masks"


def _jax_pipe(**opts):
    return jengine.CellSegmentationPipeline(
        sam_config=jax_tiny(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **{**OPTS, **opts}))


def _port_pipe(**opts):
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **{**OPTS, **opts}))


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return [make_cell_image(rng, 64, 64) for _ in range(n)]


def _png_dir(path, frames):
    path.mkdir()
    for i, im in enumerate(frames):
        write_png(path / f"im_{i}.png", im)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines' process_directory over 5 frames at batch 2, with the
    visualisations: the timing sample, then the overlapped path."""
    tmp = tmp_path_factory.mktemp("dir")
    frames = _frames(7, 5)
    src = _png_dir(tmp / "in", frames)
    jp, tp = _jax_pipe(), _port_pipe()
    jb = jp.process_directory(src, tmp / "jax", save_visualizations=True, progress=False)
    tb = tp.process_directory(src, tmp / "port", save_visualizations=True, progress=False)
    return {"frames": frames, "jp": jp, "tp": tp, "jb": jb, "tb": tb,
            "jdir": tmp / "jax" / jp.run_id, "tdir": tmp / "port" / tp.run_id}


def test_directory_matches_jax(runs):
    """(a) The same images and cell counts; the same CSV columns in order;
    each cell's mask TIFF read back: areas differ by at most the differing
    pixels, and every metric of an identical mask agrees (the tolerances of
    ``test_segment_and_metrics_on_jax_boxes``)."""
    jb, tb = runs["jb"], runs["tb"]
    assert [Path(r.image_path).name for r in tb.results] == \
        [Path(r.image_path).name for r in jb.results]
    assert [r.num_cells for r in tb.results] == [r.num_cells for r in jb.results]
    assert sum(r.num_cells for r in tb.results) > 0
    jreporting.save_results_to_csv(jb, runs["jdir"])
    treporting.save_results_to_csv(tb, runs["tdir"])
    for name in ("cell_metrics.csv", "processing_times.csv"):
        heads = [(d / name).read_text().splitlines()[0] for d in (runs["jdir"], runs["tdir"])]
        assert heads[0] == heads[1], name
    same_masks = 0
    for jr, tr in zip(jb.results, tb.results):
        stem = Path(jr.image_path).stem
        for i, (jm, tm) in enumerate(zip(jr.cell_metrics, tr.cell_metrics)):
            jmask = jtiff.read_tiff(runs["jdir"] / MASKS / f"{stem}_cell_{i}_mask.tiff")
            tmask = ttiff.read_tiff(runs["tdir"] / MASKS / f"{stem}_cell_{i}_mask.tiff")
            diff = int((jmask != tmask).sum())
            assert abs(tm["area"] - jm["area"]) <= diff
            if diff == 0:
                same_masks += 1
                for key in METRIC_KEYS:
                    np.testing.assert_allclose(tm[key], jm[key], rtol=1e-4, atol=1e-3,
                                               err_msg=key)
    assert same_masks > 0


def test_directory_matches_own_stage_api(runs):
    """(b) The overlapped path's rows equal the synced stage API on the same
    2-image groups; every image has a timing row; the wall attribution
    counts every leg (JAX's ``test_async_directory_path_matches_stage_api``)."""
    tp, frames = runs["tp"], runs["frames"]
    by_name = {Path(r.image_path).name: r for r in runs["tb"].results}
    for start in range(0, 5, 2):
        group = frames[start:start + 2]
        out = tp.process_batch_arrays(np.stack(group))
        for j in range(len(group)):
            res = by_name[f"im_{start + j}.png"]
            assert res.num_cells == int(out["valid"][j].sum())
            for row, k in zip(res.cell_metrics, np.flatnonzero(out["valid"][j])):
                for key in METRIC_KEYS:
                    want = float(out["metrics"][key][j, k])
                    if key in INT_METRIC_KEYS:  # rows carry them rounded, as the JAX rows do
                        want = float(np.round(want))
                    assert row[key] == pytest.approx(want, rel=1e-5, abs=1e-5), key
    for res in runs["tb"].results:
        for key in ("image_load", "yolo_detection", "sam_preprocess", "sam_inference_total",
                    "metrics_total", "total_time"):
            assert key in res.timing
    stats = tp.last_directory_stats
    for key in ("decode_s", "dispatch_s", "fetch_s", "assemble_s", "sample_sync_s", "vis_s",
                "wall_s"):
        assert isinstance(stats[key], float) and stats[key] >= 0.0
    assert (stats["n_images"], stats["n_batches"], stats["n_sample_batches"]) == (5, 3, 1)
    assert stats["dispatch_s"] > 0.0 and stats["wall_s"] >= stats["sample_sync_s"]
    assert (runs["tdir"] / "pipeline_parameters.json").is_file()


def test_sub_batch_timing_sample(tmp_path, monkeypatch):
    """(b) E2E_SAMPLE_BATCH below the batch: the sample runs on a sub-batch,
    every row carries the same sampled per-image stage seconds (JAX's
    ``test_sub_batch_timing_sample``)."""
    monkeypatch.setenv("E2E_SAMPLE_BATCH", "1")
    frames = _frames(11, 4)
    tp = _port_pipe()
    batch = tp.process_directory(_png_dir(tmp_path / "in", frames), tmp_path / "out",
                                 progress=False)
    assert len(batch.results) == 4
    keys = ("yolo_detection", "sam_preprocess", "sam_inference_total", "metrics_total")
    first = {k: batch.results[0].timing[k] for k in keys}
    for res in batch.results:
        for k in keys:
            assert res.timing[k] > 0.0
            assert res.timing[k] == pytest.approx(first[k], rel=1e-9)
    out = tp.process_batch_arrays(np.stack(frames[:2]))
    by_name = {Path(r.image_path).name: r for r in batch.results}
    for j in range(2):
        assert by_name[f"im_{j}.png"].num_cells == int(out["valid"][j].sum())


@pytest.mark.parametrize("cm", [48, 50])
def test_pack_round_trip(cm):
    """(c) The device bitpack is ``np.packbits`` along the last axis (zero
    padding past cm), and ``_fetch_outputs`` unpacks the crops exactly."""
    tp = _port_pipe()
    gen = torch.Generator().manual_seed(cm)
    crops = torch.rand(2, 4, cm, cm, generator=gen) > 0.5  # the shapes of a batch of 2
    np.testing.assert_array_equal(tengine.pack_bits(crops).numpy(),
                                  np.packbits(crops.numpy(), axis=-1))
    zeros = torch.zeros(2, 4)
    outputs = (torch.zeros(2, 4, 4), zeros, zeros > 0, crops,
               torch.zeros(2, 4, 2, dtype=torch.long), {key: zeros for key in METRIC_KEYS})
    tp.process_batch_arrays(np.stack(_frames(1, 2)))  # one slot's buffers made in inference mode
    for _ in range(4):  # every slot of the ring, outside inference mode
        out = tp._fetch_outputs(tp._start_fetch(tp._acquire_slot(), outputs, fetch_masks=True))
        assert out["mask_crops"].dtype == np.bool_
        np.testing.assert_array_equal(out["mask_crops"], crops.numpy())


def test_fused_call_chunked_matches_fused_call():
    """(d) Two batches in one chunked call equal two fused calls."""
    tp = _port_pipe()
    frames = torch.from_numpy(np.stack(_frames(3, 4)).reshape(2, 2, 64, 64, 3))
    chunked = tp.fused_call_chunked(frames)
    for n in range(2):
        single = tp.fused_call(frames[n])
        for got, want in zip(chunked[:5], single[:5]):
            torch.testing.assert_close(got[n], want, rtol=0, atol=0)
        for key in METRIC_KEYS:
            torch.testing.assert_close(chunked[5][key][n], single[5][key], rtol=0, atol=0)


def test_loader_matches_jax(tmp_path):
    """(e) Gray, RGB and replicated-RGB PNGs, a 16-bit TIFF, two frame shapes
    and a zero-byte file: the same batches, n_valid and skipped report."""
    rng = np.random.default_rng(5)
    src = tmp_path / "in"
    src.mkdir()
    gray = make_cell_image(rng, 64, 64)[..., 0]
    write_png(src / "a_gray.png", gray)
    write_png(src / "b_rgb.png", rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    write_png(src / "c_repl.png", make_cell_image(rng, 64, 64))
    write_png(src / "d_wide.png", make_cell_image(rng, 48, 80)[..., 0])
    jtiff.write_tiff(src / "e_16bit.tif", (gray.astype(np.uint16) * 257))
    write_png(src / "f_wide_rgb.png", rng.integers(0, 256, (48, 80, 3), dtype=np.uint8))
    (src / "g_empty.png").write_bytes(b"")
    files = sorted(src.iterdir())
    got = {}
    for name, mod in (("jax", jloader), ("port", tloader)):
        report = tmp_path / f"{name}_skipped.txt"
        got[name] = (list(mod.batched_image_loader(files, 2, skipped_report=report)),
                     report.read_text())
    (jb, jrep), (tb, trep) = got["jax"], got["port"]
    assert trep == jrep and "g_empty.png" in trep
    assert len(tb) == len(jb) == 5  # a full gray batch, then each shape's remainder
    for (ja, jpaths, jn, _), (ta, tpaths, tn, _) in zip(jb, tb):
        assert (tpaths, tn) == (jpaths, jn)
        np.testing.assert_array_equal(ta, ja)


_MODES = {"gray": (), "rgb": (3,), "rgba": (4,)}


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_png_decoder_matches_pil(mode, filt):
    """(f) The native decoder against PIL for each colour type and each of
    the five scanline filters (PIL not used by the port's decode)."""
    from PIL import Image

    img = np.random.default_rng(filt).integers(0, 256, (37, 45) + _MODES[mode], dtype=np.uint8)
    data = png_bytes(img, filt)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = decode_png(data)
    np.testing.assert_array_equal(got, want if mode != "rgba" else want[..., :3])
    if mode == "rgb":  # replicated channels collapse only when asked
        repl = np.repeat(img[..., :1], 3, axis=-1)
        np.testing.assert_array_equal(decode_png(png_bytes(repl, filt), collapse=True),
                                      repl[..., 0])
        assert decode_png(data, collapse=True).shape == img.shape


@pytest.mark.parametrize("kind", ["gray", "rgb", "uint16", "strips", "optimized", "mask"])
def test_tiff_round_trip_with_jax(tmp_path, kind):
    """(g) The port's TIFF writers and the JAX package's write the same bytes,
    and each reads what the other wrote."""
    rng = np.random.default_rng(2)
    img = {"gray": rng.integers(0, 256, (300, 270), dtype=np.uint8),
           "rgb": rng.integers(0, 256, (70, 90, 3), dtype=np.uint8),
           "uint16": rng.integers(0, 65536, (40, 50), dtype=np.uint16),
           "strips": rng.integers(0, 256, (33, 20, 3), dtype=np.uint8),
           "optimized": rng.integers(0, 256, (3, 40, 50), dtype=np.uint8),
           "mask": rng.random((60, 70)) > 0.5}[kind]
    paths = {}
    for name, tiff, utils in (("jax", jtiff, jimage_utils), ("port", ttiff, timage_utils)):
        paths[name] = tmp_path / f"{name}.tiff"
        if kind == "optimized":
            utils.save_optimized_tiff(img, paths[name], metadata={"frame": 3})
        elif kind == "mask":
            utils.save_mask_as_tiff(img, paths[name])
        else:
            tiff.write_tiff(paths[name], img, tile=None if kind == "strips" else (64, 64))
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    for reader, path in ((jtiff.read_tiff, paths["port"]), (ttiff.read_tiff, paths["jax"])):
        back, meta = reader(path, return_metadata=True)
        want = {"optimized": np.moveaxis(img, 0, -1), "mask": img.astype(np.uint8) * 255}
        np.testing.assert_array_equal(back, want.get(kind, img))
        assert meta == jtiff.read_tiff(paths["jax"], return_metadata=True)[1]


def _batch_result(mod):
    rows = [
        mod.ProcessingResult("a/im_0.png", [{**{k: 1.5 for k in METRIC_KEYS}, "area": 40},
                                            {**{k: 0.1 for k in METRIC_KEYS}, "area": 7,
                                             "deformability": float("nan")}], 2,
                             {"image_load": 0.01, "yolo_detection": 0.0123456789,
                              "total_time": 1e-5, "cells_processed": 2}, condition="ctl"),
        mod.ProcessingResult("a/im,1.png", [{**{k: 1e16 for k in METRIC_KEYS}, "area": 3}], 1,
                             {"image_load": 0.02, "yolo_detection": 1 / 3, "total_time": 2.0,
                              "cells_processed": 1}, condition="drug \"x\""),
    ]
    total, metrics, timing = mod.initialize_timing_dict(), [], []
    for r in rows:
        mod.update_total_timing(total, r.timing)
        mod.collect_metrics_data(metrics, r)
        mod.collect_timing_data(timing, r)
    return mod.BatchProcessingResult(rows, total, metrics, timing)


def test_reporting_bytes_match_pandas(tmp_path, monkeypatch):
    """(h) The csv-module writers give the bytes of the JAX package's pandas
    writers (a NaN metric, a condition column, quoting), and the run
    summaries are the same text."""
    import datetime as dt

    class _Frozen(dt.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5)

    monkeypatch.setattr(jreporting, "datetime", _Frozen)
    monkeypatch.setattr(treporting, "datetime", _Frozen)
    names = ("cell_metrics.csv", "processing_times.csv", "run_summary.txt")
    written = {}
    for name, rep, mod in (("jax", jreporting, jresults), ("port", treporting, tresults)):
        batch = _batch_result(mod)  # one directory: the summary names it
        rep.save_results_to_csv(batch, tmp_path)
        rep.save_run_summary(batch, Path("in"), tmp_path, "run1", 12.5)
        written[name] = [(tmp_path / f).read_bytes() for f in names]
    assert written["port"] == written["jax"]
    assert b",," in written["port"][0]  # the NaN field


def _tiny_factory(cls, dtype, sam, yolo):
    """``cls`` at the tiny configs, fp32, one batch of 4 (the runners' call)."""
    def make(**kw):
        opts = replace(kw.pop("options"), compute_dtype=dtype, **{**OPTS, "batch_size": 4})
        return cls(**kw, options=opts, sam_config=sam(), yolo_config=yolo(num_classes=1))
    return make


def test_runner_app_matches_jax(tmp_path, monkeypatch):
    """(i) The port's flat-folder runner on the CPU writes the file set the
    JAX runner writes; the arguments it cannot honour are refused."""
    from yolo_sam_inference_tpu.apps import single_batch_inference as japp
    from yolo_sam_inference_tpu_torch.apps import single_batch_inference as tapp

    monkeypatch.setattr(jengine, "CellSegmentationPipeline", _tiny_factory(
        jengine.CellSegmentationPipeline, jnp.float32, jax_tiny, JaxYoloConfig))
    monkeypatch.setattr(tengine, "CellSegmentationPipeline", _tiny_factory(
        tengine.CellSegmentationPipeline, torch.float32, sam_tiny_test, YoloConfig))
    src = _png_dir(tmp_path / "in", _frames(9, 3))
    trees = {}
    for name, app, extra in (("jax", japp, []), ("port", tapp, ["--device", "cpu"])):
        out = tmp_path / name
        assert app.main(["--input-dir", str(src), "--output-dir", str(out),
                         "--save-visualizations", *extra]) == 0
        (run_dir,) = out.iterdir()
        trees[name] = sorted(str(p.relative_to(run_dir)) for p in run_dir.rglob("*"))
    assert trees["port"] == trees["jax"]
    assert {"cell_metrics.csv", "processing_times.csv", "run_summary.txt"} <= set(trees["port"])
    for argv in (["--yolo-model", "y.pt"], ["--sam-checkpoint", "s.pt"], ["--run-id", "r"],
                 ["--hull-mode", "reference"], ["--encoder-parallel", "sp"],
                 ["--encoder-parallel", "tp"]):
        with pytest.raises(SystemExit):
            tapp.parse_args(["--input-dir", str(src), "--output-dir", "o", *argv])


def test_bench_entry_on_the_cpu(monkeypatch, capsys):
    """(j) The bench's function at a tiny cell on the CPU gives one JSON line
    with the JAX bench's keys (no vs_baseline) and the directory leg; the
    command refuses to run without a card and prints no result."""
    monkeypatch.setitem(tengine.SAM_CONFIGS, "tiny-test", sam_tiny_test)
    for key, value in dict(BENCH_SAM="tiny-test", BENCH_BATCH="2", BENCH_ITERS="1",
                           BENCH_CHUNK="2", BENCH_SIZE="64", BENCH_MAX_DET="4", BENCH_E2E="1",
                           BENCH_E2E_FILES="5").items():
        monkeypatch.setenv(key, value)
    line = json.dumps(e2e.run(device="cpu"))
    result = json.loads(line)
    assert set(result) == {"metric", "value", "unit", "p50_image_latency_ms",
                           "p99_image_latency_ms", "p50_batch_latency_ms", "batch",
                           "e2e_dir_ips", "e2e_stages", "card"}
    assert result["batch"] == 2 and result["value"] > 0 and result["e2e_stages"]["n_images"] == 5
    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "-m", "yolo_sam_inference_tpu_torch.bench.e2e"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


def test_decoder_build_failure_is_an_error_of_the_run(tmp_path, monkeypatch):
    """A PNG decoder that does not build raises with the compiler's output;
    the loader does not skip the files as unreadable."""
    from yolo_sam_inference_tpu_torch.io import png_native

    bad = tmp_path / "png_decode.cc"
    bad.write_text("int png_probe( {\n")
    monkeypatch.setattr(png_native, "SOURCE", bad)
    monkeypatch.setattr(png_native, "BUILD_ROOT", tmp_path / "build")
    png_native._load.cache_clear()
    try:
        write_png(tmp_path / "f.png", np.zeros((8, 8), np.uint8))
        with pytest.raises(png_native.NativeBuildError, match="png_decode.cc"):
            list(tloader.batched_image_loader([tmp_path / "f.png"], 1))
    finally:
        png_native._load.cache_clear()


def test_decoder_first_use_from_many_threads(tmp_path, monkeypatch):
    """The loader's decode threads may all reach the decoder before it is
    built: exactly one build runs, and every thread decodes."""
    from concurrent.futures import ThreadPoolExecutor

    from yolo_sam_inference_tpu_torch.io import png_native

    monkeypatch.setattr(png_native, "BUILD_ROOT", tmp_path / "build")
    png_native._load.cache_clear()
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    try:
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda _: decode_png(png_bytes(img)), range(8)))
    finally:
        png_native._load.cache_clear()
    assert all(g is not None and np.array_equal(g, img) for g in got)
