"""The port's apps against the JAX package's, on the CPU: the ROI gate, the
project runner, MLflow tracking, the int8 calibration report, the frame
cleaner, and the ``io/`` pieces they need (PNG written without PIL, the
recursive listing).

Pipelines run at the tiny sizes of ``tests/test_torch_directory.py`` (fp32,
``sam_tiny_test``, YOLOv8n at a 64-pixel letterbox, 64x64 ``tests/synth.py``
frames) from one seed. Where an app's own logic is compared, both apps are
given the same pipeline (the port's), so their outputs must be equal; where
the engines are compared, the tolerances are the directory path's.
"""

import csv
import io
import json
import math
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from fakes import FakeMlflowState, make_fake_mlflow
from synth import make_cell_image
from yolo_sam_inference_tpu.apps import project_inference as japp
from yolo_sam_inference_tpu.apps import quant_report as jquant
from yolo_sam_inference_tpu.apps import yolo_frame_cleaner as jclean
from yolo_sam_inference_tpu.gate import filter as jfilter
from yolo_sam_inference_tpu.io import images as jimages
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu.pipeline import results as jresults
from yolo_sam_inference_tpu.registry import tracking as jtracking
from yolo_sam_inference_tpu_torch.apps import project_inference as tapp
from yolo_sam_inference_tpu_torch.apps import quant_report as tquant
from yolo_sam_inference_tpu_torch.apps import yolo_frame_cleaner as tclean
from yolo_sam_inference_tpu_torch.bench.common import write_png
from yolo_sam_inference_tpu_torch.gate import filter as tfilter
from yolo_sam_inference_tpu_torch.io import images as timages
from yolo_sam_inference_tpu_torch.io.png import decode_png_alpha, png_bytes
from yolo_sam_inference_tpu_torch.io.png_native import decode_png
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.pipeline import results as tresults
from yolo_sam_inference_tpu_torch.registry import tracking as ttracking

torch.set_num_threads(1)

OPTS = dict(yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64)


def _port_pipe(**opts):
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32,
                                        **{**OPTS, "batch_size": 2, **opts}))


def _tiny_factory(cls, dtype, sam, yolo):
    """``cls`` at the tiny configs, fp32, batches of 2 (times num_pipelines)."""
    def make(**kw):
        opts = replace(kw.pop("options"), compute_dtype=dtype, **{**OPTS, "batch_size": 2})
        return cls(**kw, options=opts, sam_config=sam(), yolo_config=yolo(num_classes=1))
    return make


def _read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _same_rows(got, want):
    """CSV rows of two engines: the same columns, ints and strings equal,
    floats within the directory path's tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if key in ("condition", "image_name") or key in INT_METRIC_KEYS or key == "cell_id":
                assert g[key] == w[key], key
            else:
                assert float(g[key]) == pytest.approx(float(w[key]), rel=1e-4, abs=1e-3), key


# --------------------------------------------------------------------- gate


def _rows(seed, n=60):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        lo = float(rng.uniform(0, 100))
        rows.append({"condition": str(rng.choice(["ctrl", "drug", "other"])),
                     "image_name": f"im_{i % 7}.png", "cell_id": i,
                     "min_y": lo, "max_y": lo + float(rng.uniform(0, 30)),
                     "min_x": float(rng.uniform(0, 100)), "max_x": float(rng.uniform(100, 130)),
                     "area": int(rng.integers(10, 500))})
    rows[3]["min_y"] = math.nan  # outside every ROI
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_cells_by_roi_matches_jax(seed):
    """The same rows kept, in the same order, as the JAX filter on a frame of
    the same rows; ``condition`` "empty" has no row (warned and skipped)."""
    rows = _rows(seed)
    rois = {"drug": {"x_min": 30, "x_max": 70, "y_min": 0, "y_max": 10**9},
            "empty": {"x_min": 0, "x_max": 10**9, "y_min": 0, "y_max": 10**9},
            "ctrl": {"x_min": 10, "x_max": 50, "y_min": 0, "y_max": 10**9}}
    got = tfilter.filter_cells_by_roi(rows, rois)
    want = jfilter.filter_cells_by_roi(pd.DataFrame(rows), rois)
    assert [rows.index(r) for r in got] == want.index.tolist()
    assert 0 < len(got) < len(rows)


def test_filter_cells_by_roi_axis_swap_and_errors():
    """The gate reads the row centre ``(min_y + max_y) / 2`` against x_min /
    x_max (the reference's deliberate swap), as the JAX gate does; missing
    columns raise in both; an empty result is an empty list."""
    roi = {"c": {"x_min": 0, "x_max": 20, "y_min": 0, "y_max": 20}}
    in_y = {"condition": "c", "min_y": 5.0, "max_y": 15.0, "min_x": 100.0, "max_x": 120.0}
    in_x = {"condition": "c", "min_y": 100.0, "max_y": 120.0, "min_x": 5.0, "max_x": 15.0}
    assert tfilter.filter_cells_by_roi([in_y, in_x], roi) == [in_y]
    assert jfilter.filter_cells_by_roi(pd.DataFrame([in_y, in_x]), roi).index.tolist() == [0]
    for bad in ([{"condition": "c", "min_y": 1}], []):
        with pytest.raises(ValueError, match="max_y"):
            tfilter.filter_cells_by_roi(bad, roi)
        with pytest.raises(ValueError, match="max_y"):
            jfilter.filter_cells_by_roi(pd.DataFrame(bad), roi)
    assert tfilter.filter_cells_by_roi([in_x], roi) == []


def test_roi_coordinates_file_matches_jax(tmp_path):
    rois = {"a": {"x_min": 1, "x_max": 9, "y_min": 0, "y_max": 10**9}}
    tfilter.save_roi_coordinates(rois, tmp_path / "t.json")
    jfilter.save_roi_coordinates(rois, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tfilter.load_roi_coordinates(tmp_path / "t.json") == rois


@pytest.mark.parametrize("source", ["file", "roi2", "roi4", "none"])
def test_resolve_rois_matches_jax(source, tmp_path):
    roi_file = tmp_path / "rois.json"
    roi_file.write_text(json.dumps({"a": {"x_min": 3, "x_max": 4, "y_min": 5, "y_max": 6}}))
    argv = ["--project-dir", str(tmp_path), "--output-dir", "o"] + {
        "file": ["--roi-file", str(roi_file)], "roi2": ["--roi", "10,50"],
        "roi4": ["--roi", "10,50,2,60"], "none": []}[source]
    names = ["a", "b"]
    got = tapp.resolve_rois(tapp.parse_args(argv), names)
    assert got == japp.resolve_rois(japp.parse_args(argv), names)


@pytest.mark.parametrize("roi", ["10", "1,2,3", "a,b"])
def test_malformed_roi_exits_like_jax(roi, tmp_path):
    argv = ["--project-dir", str(tmp_path), "--output-dir", "o", "--roi", roi]
    for app in (tapp, japp):
        with pytest.raises(SystemExit, match="--roi must be"):
            app.resolve_rois(app.parse_args(argv), ["a"])


@pytest.mark.parametrize("argv", [
    ["--encoder-parallel", "sp"],
    ["--encoder-parallel", "tp"],
    ["--parallel-devices", "2"],
])
def test_project_runner_refuses_what_is_not_ported(argv, capsys):
    """Nothing is refused any more: sp, tp and ``--parallel-devices`` parse
    (tp since the tensor-parallel encoder was ported); an unknown mode
    still exits through argparse."""
    args = tapp.parse_args(["--project-dir", "p", "--output-dir", "o", *argv])
    assert (args.encoder_parallel, args.parallel_devices) != ("none", 0)
    with pytest.raises(SystemExit):
        tapp.parse_args(["--project-dir", "p", "--output-dir", "o", "--encoder-parallel", "pp"])
    assert "invalid choice" in capsys.readouterr().err


# ----------------------------------------------------------- project runner


def _project(root):
    """Two conditions x two batch folders x two 64x64 PNG frames, one more
    frame directly under condition ``a``, and a condition with no image."""
    rng = np.random.default_rng(21)
    for cond in ("a", "b"):
        for b in ("batch_1", "batch_2"):
            (root / cond / b).mkdir(parents=True)
            for i in range(2):
                write_png(root / cond / b / f"img_{i}.png", make_cell_image(rng, 64, 64))
    write_png(root / "a" / "loose.png", make_cell_image(rng, 64, 64))
    (root / "c_empty").mkdir()
    return root


def test_collect_images_from_batches_matches_jax(tmp_path):
    root = _project(tmp_path / "p")
    for cond in ("a", "b", "c_empty"):
        assert tapp.collect_images_from_batches(root / cond) == \
            japp.collect_images_from_batches(root / cond)


@pytest.fixture(scope="module")
def project_runs(tmp_path_factory):
    """The JAX runner and the port's on one project, each on its own engine,
    with an ROI file that keeps condition a's cells and drops b's (the tiny
    pipelines' masks fill the frame: every cell's centre is 32)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("proj")
    root = _project(tmp / "project")
    rois = tmp / "rois.json"
    rois.write_text(json.dumps({"a": {"x_min": 0, "x_max": 40, "y_min": 0, "y_max": 64},
                                "b": {"x_min": 40, "x_max": 64, "y_min": 0, "y_max": 64},
                                "c_empty": {"x_min": 0, "x_max": 64, "y_min": 0, "y_max": 64}}))
    mp.setattr(jengine, "ParallelCellSegmentationPipeline", _tiny_factory(
        jengine.ParallelCellSegmentationPipeline, jnp.float32, jax_tiny, JaxYoloConfig))
    mp.setattr(tengine, "ParallelCellSegmentationPipeline", _tiny_factory(
        tengine.ParallelCellSegmentationPipeline, torch.float32, sam_tiny_test, YoloConfig))
    try:
        dirs = {}
        for name, app, extra in (("jax", japp, []), ("port", tapp, ["--device", "cpu"])):
            out = tmp / name
            assert app.main(["--project-dir", str(root), "--output-dir", str(out),
                             "--roi-file", str(rois), *extra]) == 0
            (dirs[name],) = out.iterdir()
    finally:
        mp.undo()
    return dirs


def test_project_runner_matches_jax(project_runs):
    """The same file tree; the same rows in every CSV (the engines'
    tolerances), the same ROI file."""
    trees = {name: sorted(str(p.relative_to(d)).replace(d.name, "RUN")
                          for p in d.rglob("*"))
             for name, d in project_runs.items()}
    assert trees["port"] == trees["jax"]
    tdir, jdir = project_runs["port"], project_runs["jax"]
    expected = {"cell_metrics.csv", "processing_times.csv", "run_summary.txt",
                "gated_cell_metrics.csv", "roi_coordinates.json", "pipeline_parameters.json",
                "a/RUN/condition_summary.txt", "a/RUN/gated_cell_metrics.csv",
                "b/RUN/cell_metrics.csv", "b/RUN/gated_cell_metrics.csv"}
    assert expected <= set(trees["port"])
    assert (tdir / "roi_coordinates.json").read_bytes() == \
        (jdir / "roi_coordinates.json").read_bytes()
    for rel in ("cell_metrics.csv", "gated_cell_metrics.csv", "a/RUN/cell_metrics.csv",
                "a/RUN/gated_cell_metrics.csv", "b/RUN/gated_cell_metrics.csv"):
        t = tdir / rel.replace("RUN", tdir.name)
        j = jdir / rel.replace("RUN", jdir.name)
        _same_rows(_read_rows(t), _read_rows(j))
    assert len(_read_rows(tdir / "processing_times.csv")) == 9
    summary = (tdir / "run_summary.txt").read_text()
    assert "Condition: a" in summary and "Total images processed: 9" in summary


def test_project_runner_gates_its_own_rows(project_runs):
    """The combined CSV is the per-condition files one after the other; the
    gated CSV is ``filter_cells_by_roi`` of the combined rows (columns in the
    combined order, the fixed three first), each condition's gated file its
    share, and some cells fall on each side of the ROI."""
    tdir = project_runs["port"]
    run = tdir.name
    combined = _read_rows(tdir / "cell_metrics.csv")
    parts = {c: _read_rows(tdir / c / run / "cell_metrics.csv") for c in ("a", "b")}
    assert combined == parts["a"] + parts["b"]
    rois = json.loads((tdir / "roi_coordinates.json").read_text())
    assert set(rois) == {"a", "b", "c_empty"}
    numeric = [{**r, "min_y": float(r["min_y"]), "max_y": float(r["max_y"])} for r in combined]
    kept = tfilter.filter_cells_by_roi(numeric, rois)
    gated = _read_rows(tdir / "gated_cell_metrics.csv")
    assert gated == [combined[numeric.index(r)] for r in kept]
    assert 0 < len(gated) < len(combined)
    assert {r["condition"] for r in gated} == {"a"}
    for c in ("a", "b"):
        assert _read_rows(tdir / c / run / "gated_cell_metrics.csv") == \
            [r for r in gated if r["condition"] == c]
    header = (tdir / "gated_cell_metrics.csv").read_text().splitlines()[0]
    assert header == (tdir / "cell_metrics.csv").read_text().splitlines()[0]
    assert header.startswith("condition,image_name,cell_id,")


def test_project_runner_profile_and_mlflow(tmp_path, monkeypatch):
    """``--profile-dir`` writes a chrome trace of the run with the engine's
    spans as ranges on it; ``--log-to-mlflow``
    logs the params, the gated count and the outputs (a fake mlflow);
    ``--roi`` that keeps nothing still writes the gated files' headers."""
    root = _project(tmp_path / "project")
    state = FakeMlflowState(artifact_root=tmp_path)
    monkeypatch.setitem(sys.modules, "mlflow", make_fake_mlflow(state))
    monkeypatch.setattr(tengine, "ParallelCellSegmentationPipeline", _tiny_factory(
        tengine.ParallelCellSegmentationPipeline, torch.float32, sam_tiny_test, YoloConfig))
    assert tapp.main(["--project-dir", str(root), "--output-dir", str(tmp_path / "out"),
                      "--device", "cpu", "--roi", "5000,6000", "--profile-dir",
                      str(tmp_path / "prof"), "--log-to-mlflow"]) == 0
    (run_dir,) = (tmp_path / "out").iterdir()
    (trace,) = (tmp_path / "prof").glob("*.trace.json")
    assert trace.name == f"{run_dir.name}.trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"detect", "nms", "embed", "segment", "metrics"} <= names  # the engine's spans
    gated = (run_dir / "gated_cell_metrics.csv").read_text()
    assert gated.splitlines() == [(run_dir / "cell_metrics.csv").read_text().splitlines()[0]]
    run = state.runs[-1]
    assert run["status"] == "FINISHED"
    assert run["params"]["conditions"] == "a,b,c_empty"
    assert run["metrics"]["gated_cells"] == 0.0 and run["metrics"]["images_processed"] == 9.0
    logged = {Path(p).name for p in run["artifacts"]}
    assert {"cell_metrics.csv", "gated_cell_metrics.csv", "roi_coordinates.json",
            "area_histogram.png", "condition_counts.png", "area_vs_circularity.png"} <= logged


# ------------------------------------------------------------------ tracking


def _batch(mod):
    rows = [mod.ProcessingResult(f"im_{i}.png", [{"area": 10 * i}] * i, i,
                                 {"yolo_detection": 0.01 * i}, condition=c)
            for i, c in enumerate(["a", "b", None, "a"])]
    total = mod.initialize_timing_dict()
    for r in rows:
        mod.update_total_timing(total, {**r.timing, "cells_processed": r.num_cells})
    return mod.BatchProcessingResult(rows, total, [], [])


def test_collect_run_metrics_matches_jax():
    assert ttracking.collect_run_metrics(_batch(tresults), 7) == \
        jtracking.collect_run_metrics(_batch(jresults), 7)
    assert ttracking.collect_run_metrics(_batch(tresults)) == \
        jtracking.collect_run_metrics(_batch(jresults))


@pytest.mark.parametrize("mlflow", ["fake", "absent", "disabled"])
def test_tracked_run_matches_jax(mlflow, tmp_path, monkeypatch):
    """The same calls reach a fake mlflow from both; without mlflow (the
    card's machine has none), or disabled, a null tracker; FAILED on an
    exception."""
    art = tmp_path / "cell_metrics.csv"
    art.write_text("area\n1\n")
    states = {}
    for name, mod in (("jax", jtracking), ("port", ttracking)):
        state = states[name] = FakeMlflowState(artifact_root=tmp_path)
        monkeypatch.setitem(sys.modules, "mlflow",
                            make_fake_mlflow(state) if mlflow == "fake" else None)
        with mod.tracked_run("exp", run_name="r1", enabled=mlflow != "disabled") as t:
            assert t.enabled == (mlflow == "fake")
            t.log_params({"batch": 8, "model": "vit-b"})
            t.log_metrics({"cells": 12, "skipme": None})
            t.log_artifact(art)
            t.log_run_outputs(tmp_path)
        with pytest.raises(ValueError):
            with mod.tracked_run("exp"):
                raise ValueError("boom")
    assert states["port"].runs == states["jax"].runs
    if mlflow == "fake":
        assert [r["status"] for r in states["port"].runs] == ["FINISHED", "FAILED"]
        assert states["port"].runs[0]["artifacts"].count(str(art)) == 2


def test_summary_figures_on_rows(tmp_path, monkeypatch):
    """Figures from row dicts: the JAX figures' three files (from a frame of
    the same rows); none without matplotlib."""
    rng = np.random.default_rng(4)
    rows = [{"area": int(a), "circularity": float(c), "condition": cond}
            for a, c, cond in zip(rng.integers(100, 1000, 50), rng.random(50),
                                  ["a"] * 25 + ["b"] * 25)]
    got = ttracking.create_summary_figures(rows, tmp_path / "t")
    want = jtracking.create_summary_figures(pd.DataFrame(rows), tmp_path / "j")
    assert [p.name for p in got] == [p.name for p in want]
    assert all(p.stat().st_size > 500 for p in got)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert ttracking.create_summary_figures(rows, tmp_path / "none") == []


# ------------------------------------------------------------- quant report


def _outputs(rng, b=3, k=5, cm=8):
    return {"valid": rng.random((b, k)) < 0.7,
            "mask_crops": rng.random((b, k, cm, cm)) < 0.5,
            "metrics": {key: rng.random((b, k)).astype(np.float32) for key in METRIC_KEYS}}


@pytest.mark.parametrize("n_valid", [1, 3])
def test_compare_outputs_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    out_f, out_q = _outputs(rng), _outputs(rng)
    out_q["mask_crops"][0, 0] = False
    out_f["mask_crops"][0, 0] = False  # an empty union: IoU 1
    out_f["valid"][0, 0] = out_q["valid"][0, 0] = True
    assert tquant.compare_outputs(out_f, out_q, n_valid) == \
        jquant.compare_outputs(out_f, out_q, n_valid)


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    src = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(31)
    for i in range(5):
        write_png(src / f"f_{i}.png", make_cell_image(rng, 64, 64))
    return src


def test_run_report_matches_jax(frame_dir, tmp_path):
    """Both reports over the port's bf16-mode and int8 pipelines (fp32
    compute, one seed) write the same bytes and return the same summary;
    each quantity's n counts the matched detections."""
    files = timages.list_image_files(frame_dir)
    pf, pq = _port_pipe(), _port_pipe(quant="int8")
    got = tquant.run_report(pf, pq, files, tmp_path / "t", batch_size=2)
    want = jquant.run_report(pf, pq, files, tmp_path / "j", batch_size=2)
    assert got == want
    for name in ("quant_calibration.csv", "quant_calibration_summary.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert "5 images" in (tmp_path / "t" / "quant_calibration_summary.txt").read_text()
    assert got["iou"]["n"] == got["area"]["n"] > 0


def test_quant_report_main_matches_jax(frame_dir, tmp_path, monkeypatch, capsys):
    """Each tool on its own engine, end to end: the same files, the same
    quantities and counts of matched detections in its JSON line."""
    monkeypatch.setattr(jquant, "CellSegmentationPipeline", _tiny_factory(
        jengine.CellSegmentationPipeline, jnp.float32, jax_tiny, JaxYoloConfig))
    monkeypatch.setattr(tquant, "CellSegmentationPipeline", _tiny_factory(
        tengine.CellSegmentationPipeline, torch.float32, sam_tiny_test, YoloConfig))
    lines = {}
    for name, mod, extra in (("jax", jquant, []), ("port", tquant, ["--device", "cpu"])):
        capsys.readouterr()
        assert mod.main(["--input-dir", str(frame_dir), "--output-dir", str(tmp_path / name),
                         "--batch-size", "2", *extra]) == 0
        lines[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(lines["port"]) == set(lines["jax"]) == {"n", "iou_mean",
                                                         "deformability_max_delta"}
    assert lines["port"]["n"] == lines["jax"]["n"] > 0
    quantities = {name: [r["quantity"] for r in _read_rows(tmp_path / name /
                                                            "quant_calibration.csv")]
                  for name in lines}
    assert quantities["port"] == quantities["jax"]


# ------------------------------------------------------------ frame cleaner


@pytest.mark.parametrize("seed", range(4))
def test_frame_classification_matches_jax(seed):
    """``classify_frame``, ``is_box_fully_contained`` and ``center_in_roi``
    on seeded boxes, scores and ROIs give the JAX answers."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(0, 4))
        boxes = np.sort(rng.uniform(0, 64, (n, 2, 2)), axis=1).transpose(0, 2, 1).reshape(n, 4)
        boxes = boxes[:, [0, 2, 1, 3]]  # (x0, y0, x1, y1)
        scores, valid = rng.random(n), rng.random(n) < 0.8
        x0, y0 = rng.integers(0, 20, 2)
        roi = {"x_min": int(x0), "y_min": int(y0), "x_max": int(x0 + rng.integers(20, 50)),
               "y_max": int(y0 + rng.integers(20, 50))}
        kind, box = tclean.classify_frame(boxes, scores, valid, roi, 0.5)
        jkind, jbox = jclean.classify_frame(boxes, scores, valid, roi, 0.5)
        assert kind == jkind and (box is None) == (jbox is None)
        if box is not None:
            np.testing.assert_array_equal(box, jbox)
        for b in boxes:
            assert tclean.is_box_fully_contained(b, roi) == jclean.is_box_fully_contained(b, roi)
            assert tclean.center_in_roi(b, roi) == jclean.center_in_roi(b, roi)


def test_frame_cleaner_classification():
    """The JAX package's ``tests/test_tools.py`` cases on the port."""
    roi = {"x_min": 0, "y_min": 0, "x_max": 100, "y_max": 100}
    boxes = np.array([[10, 10, 30, 30], [0, 0, 5, 5]], dtype=float)
    kind, box = tclean.classify_frame(boxes, np.array([0.9, 0.1]), np.array([True, True]), roi)
    assert kind == "target"
    np.testing.assert_array_equal(box, boxes[0])
    kind, _ = tclean.classify_frame(boxes, np.array([0.9, 0.8]), np.array([True, True]), roi)
    assert kind == "rejected"
    kind, _ = tclean.classify_frame(boxes, np.array([0.2, 0.1]), np.array([True, True]), roi)
    assert kind == "background"
    edge = np.array([[0, 10, 30, 30]], dtype=float)
    kind, _ = tclean.classify_frame(edge, np.array([0.9]), np.array([True]), roi)
    assert kind == "rejected"


class _StubDetector:
    """YOLO outputs by frame: i % 3 == 0 one contained confident box (a
    target), 1 none confident (background), 2 two confident (rejected)."""

    def __init__(self):
        self.seen = 0

    def detect_batch_arrays(self, batch):
        n = batch.shape[0]
        boxes = np.tile(np.array([[20, 20, 30, 30], [8, 20, 18, 30], [50, 50, 60, 60]], float),
                        (n, 1, 1))
        scores = np.zeros((n, 3))
        for i in range(n):
            kind = (self.seen + i) % 3
            scores[i] = {0: [0.9, 0.1, 0.1], 1: [0.1, 0.2, 0.3], 2: [0.9, 0.9, 0.9]}[kind]
        self.seen += n
        return {"boxes": boxes, "scores": scores, "valid": np.ones((n, 3), bool)}


def _decoded_tree(root):
    return {str(p.relative_to(root)): np.asarray(timages.load_image(p))
            for p in sorted(root.rglob("*.png"))}


@pytest.mark.parametrize("with_pil", [True, False])
def test_clean_frames_matches_jax(tmp_path, monkeypatch, with_pil):
    """Both cleaners on one detector (a stub with targets, background and
    rejected frames; a recursive walk): the same counts and files, each file
    the same pixels; the port's written without PIL where it is hidden."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    rng = np.random.default_rng(41)
    for i in range(7):
        write_png((src / "sub" if i % 2 else src) / f"f{i}.png", make_cell_image(rng, 64, 64))
    roi = {"x_min": 10, "y_min": 10, "x_max": 40, "y_max": 40}
    counts = {}
    for name, mod in (("jax", jclean), ("port", tclean)):
        if name == "port" and not with_pil:
            monkeypatch.setattr(timages, "_PILImage", None)
        counts[name] = mod.clean_frames(src, tmp_path / name, _StubDetector(), roi=roi,
                                        recursive=True, batch_size=3)
    assert counts["port"] == counts["jax"] == {"target": 3, "background": 2, "rejected": 2}
    got, want = _decoded_tree(tmp_path / "port"), _decoded_tree(tmp_path / "jax")
    assert list(got) == list(want)
    assert "full_frames_with_target/f1_background.png" in got  # the pool f2, sub/f1: its middle
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_frame_cleaner_debug_visualizations(tmp_path):
    """The JAX case on the port: blue ROI box, green contained detection,
    yellow boundary-toucher, red outside."""
    src = tmp_path / "src"
    src.mkdir()
    for i in range(2):
        write_png(src / f"f{i}.png", np.zeros((64, 64, 3), np.uint8))

    class Stub:
        def detect_batch_arrays(self, batch):
            n = batch.shape[0]
            boxes = np.tile(np.array([[20, 20, 30, 30], [8, 20, 18, 30], [50, 50, 60, 60]],
                                     float), (n, 1, 1))
            return {"boxes": boxes, "scores": np.full((n, 3), 0.9),
                    "valid": np.ones((n, 3), bool)}

    roi = {"x_min": 10, "y_min": 10, "x_max": 40, "y_max": 40}
    tclean.clean_frames(src, tmp_path / "out", Stub(), roi=roi, conf=0.5)
    dbg = sorted((tmp_path / "out" / "debug_visualizations").glob("debug_*_detections.png"))
    assert len(dbg) == 2
    img = timages.load_image(dbg[0])
    assert tuple(img[40, 35]) == (0, 0, 255)
    assert tuple(img[20, 25]) == (0, 255, 0)
    assert tuple(img[25, 9]) == (255, 255, 0)
    assert tuple(img[50, 55]) == (255, 0, 0)


def test_frame_cleaner_no_debug_flag(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    write_png(src / "a.png", np.zeros((32, 32, 3), np.uint8))

    class Stub:
        def detect_batch_arrays(self, batch):
            n = batch.shape[0]
            return {"boxes": np.zeros((n, 1, 4)), "scores": np.zeros((n, 1)),
                    "valid": np.zeros((n, 1), bool)}

    tclean.clean_frames(src, tmp_path / "out", Stub(), debug_visualizations=False)
    assert not (tmp_path / "out" / "debug_visualizations").exists()


@pytest.mark.parametrize("conf", ["0.4", "0.6"])
def test_frame_cleaner_main_matches_jax(conf, frame_dir, tmp_path, monkeypatch):
    """Each cleaner on its own engine from the command line: the same file
    names (every frame rejected at conf 0.4, background at 0.6: the tiny
    YOLO's scores sit near 0.5 and its boxes fill the frame)."""
    monkeypatch.setattr(jengine, "CellSegmentationPipeline", _tiny_factory(
        jengine.CellSegmentationPipeline, jnp.float32, jax_tiny, JaxYoloConfig))
    monkeypatch.setattr(tengine, "CellSegmentationPipeline", _tiny_factory(
        tengine.CellSegmentationPipeline, torch.float32, sam_tiny_test, YoloConfig))
    names = {}
    for name, mod, extra in (("jax", jclean, []), ("port", tclean, ["--device", "cpu"])):
        out = tmp_path / name
        assert mod.main(["--input-dir", str(frame_dir), "--output-dir", str(out), "--conf", conf,
                         "--roi", "0,0,64,64", "--batch-size", "2", *extra]) == 0
        names[name] = sorted(str(p.relative_to(out)) for p in out.rglob("*"))
    assert names["port"] == names["jax"]
    assert len([n for n in names["port"] if n.startswith("debug_visualizations/")]) == 5


def test_frame_cleaner_main_errors(tmp_path, capsys):
    assert tclean.main(["--input-dir", str(tmp_path / "none"), "--output-dir", "o"]) == 2
    assert tclean.main(["--input-dir", str(tmp_path), "--output-dir", "o",
                        "--run-id", "r"]) == 2
    assert "both --experiment-id and --run-id" in capsys.readouterr().out


# ------------------------------------------------------------- io repairs


@pytest.mark.parametrize("shape", [(20, 30), (20, 30, 3), (20, 30, 4)])
@pytest.mark.parametrize("with_pil", [True, False])
def test_save_image_png_round_trip(shape, with_pil, tmp_path, monkeypatch):
    """``save_image`` writes PNG without PIL; the port's decoder and PIL read
    back the same pixels; a format only PIL writes needs it."""
    from PIL import Image

    if not with_pil:
        monkeypatch.setattr(timages, "_PILImage", None)
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    timages.save_image(tmp_path / "x.png", img)
    data = (tmp_path / "x.png").read_bytes()
    ours = decode_png_alpha(data) if img.ndim == 3 and shape[2] == 4 else decode_png(data)
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    timages.save_image(tmp_path / "x.tiff", img[..., :3] if img.ndim == 3 else img)
    if with_pil:
        timages.save_image(tmp_path / "x.jpg", img[..., :3] if img.ndim == 3 else img)
    else:
        with pytest.raises(RuntimeError, match="PIL"):
            timages.save_image(tmp_path / "x.jpg", img)


@pytest.mark.parametrize("channels", [2, 4])
@pytest.mark.parametrize("filter_type", range(5))
def test_png_alpha_decoder(channels, filter_type):
    """Gray + alpha and RGBA under every filter type: the alpha plane kept,
    as PIL reads it."""
    from PIL import Image

    img = np.random.default_rng(filter_type).integers(0, 256, (9, 13, channels), dtype=np.uint8)
    data = png_bytes(img, filter_type)
    np.testing.assert_array_equal(decode_png_alpha(data), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    with pytest.raises(ValueError):
        decode_png_alpha(png_bytes(img[..., 0], filter_type))


def test_list_image_files_recursive_matches_jax(tmp_path):
    for rel in ("a.png", "b.TIF", "c.txt", "sub/d.jpg", "sub/deeper/e.png", "sub/f.json"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    for recursive in (False, True):
        assert timages.list_image_files(tmp_path, recursive=recursive) == \
            jimages.list_image_files(tmp_path, recursive=recursive)
    assert len(timages.list_image_files(tmp_path, recursive=True)) == 4
