"""The port's results store against the JAX package's, on the CPU.

The work manifest (``registry/manifest.py``: its sqlite files read back
through either package), ``process_pending`` (``registry/nodes.py``) on the
port's tiny CPU pipeline against the JAX tiny pipeline on the same weights
(one seed), the batch readout without pandas (``registry/readout.py``: the
JAX function's CSV bytes), the Postgres adapter and the MinIO paths on the
protocol fakes of ``tests/fakes.py``, the two CLIs, and the result viewer
(rendered in numpy, every value HTML-escaped: F4 in ``ROADMAP.md``). Mirrors
``tests/test_registry.py``, ``tests/test_apps_misc.py::
test_manifest_cli_roundtrip`` and the registry cases of
``tests/test_gated_adapters.py``; each case also runs the JAX function on
the same inputs. Data comes from each test's own ``default_rng(seed)``,
never the shared ``rng`` fixture of ``tests/conftest.py``, so no draw of a
JAX test shifts (F1).
"""

import base64
import io
import json
import sqlite3
import sys
import threading
import urllib.error
import urllib.request
from urllib.parse import quote

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from fakes import FakeMinioStore, FakePgStore, make_fake_minio, make_fake_psycopg2
from synth import make_cell_image
from yolo_sam_inference_tpu.apps import batch_readout as jreadout_cli
from yolo_sam_inference_tpu.apps import manifest_cli as jcli
from yolo_sam_inference_tpu.apps import result_viewer as jviewer
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu.registry import manifest as jmanifest
from yolo_sam_inference_tpu.registry import nodes as jnodes
from yolo_sam_inference_tpu.registry import postgres as jpostgres
from yolo_sam_inference_tpu.registry import readout as jreadout
from yolo_sam_inference_tpu_torch.apps import batch_readout as treadout_cli
from yolo_sam_inference_tpu_torch.apps import manifest_cli as tcli
from yolo_sam_inference_tpu_torch.apps import result_viewer as tviewer
from yolo_sam_inference_tpu_torch.bench.common import write_png
from yolo_sam_inference_tpu_torch.io.png import png_bytes
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.registry import TABLE_TEMPLATES, WorkManifest
from yolo_sam_inference_tpu_torch.registry import manifest as tmanifest
from yolo_sam_inference_tpu_torch.registry import nodes as tnodes
from yolo_sam_inference_tpu_torch.registry import postgres as tpostgres
from yolo_sam_inference_tpu_torch.registry import readout as treadout
from yolo_sam_inference_tpu_torch.utils.mask_encoding import decode_binary_mask, encode_binary_mask

torch.set_num_threads(1)

OPTS = dict(batch_size=1, max_det=4, metric_crop=48, yolo_size=64, nms_candidates=32)
BOTH = (("jax", jmanifest), ("port", tmanifest))
# the DB-facing keys of the 16 metrics (registry/manifest.py:70-80)
RESULT_KEYS = ("deformability", "area", "area_r", "circularity", "ch_area", "mean_brightness",
               "brightness_std", "perimeter", "ch_perimeter")


@pytest.fixture
def pg(monkeypatch):
    store = FakePgStore()
    monkeypatch.setitem(sys.modules, "psycopg2", make_fake_psycopg2(store))
    return store


@pytest.fixture
def minio_store(monkeypatch):
    store = FakeMinioStore()
    monkeypatch.setitem(sys.modules, "minio", make_fake_minio(store))
    return store


def _metrics(rng):
    return {"deformability": float(rng.random()), "area": int(rng.integers(50, 900)),
            "area_ratio": float(rng.uniform(1, 1.3)), "circularity": float(rng.random()),
            "convex_hull_area": int(rng.integers(50, 900)),
            "mean_brightness": float(rng.uniform(0, 255)),
            "brightness_std": float(rng.uniform(0, 20)), "perimeter": float(rng.uniform(20, 90)),
            "convex_hull_perimeter": float(rng.uniform(20, 90))}


def _schema(db):
    with sqlite3.connect(db) as conn:
        return sorted(conn.execute("SELECT type, name, sql FROM sqlite_master").fetchall())


# ------------------------------------------------------------------- manifest


def test_manifest_ingest_upsert_and_pending(tmp_path):
    """``tests/test_registry.py:22-35`` on both packages: the same pending
    lists, results and schema."""
    seen = {}
    for name, mod in BOTH:
        m = mod.WorkManifest(tmp_path / f"{name}.db")
        got = [m.ingest(["a.png", "b.png", "c.png"]), m.ingest(["b.png"]), m.pending()]
        assert got == [3, 1, ["a.png", "b.png", "c.png"]]
        m.record_result("b.png", [{"deformability": 0.1, "area": 100}])
        got.append(m.pending())
        m.ingest(["a.png", "b.png", "c.png"])  # re-ingestion keeps the results
        got += [m.pending(), m.pending(limit=1), m.get_results("b.png"), m.get_results("a.png")]
        assert got[-2][0]["area"] == 100
        seen[name] = got
        m.close()
    assert seen["port"] == seen["jax"]
    assert _schema(tmp_path / "port.db") == _schema(tmp_path / "jax.db")


def test_manifest_error_and_summary(tmp_path):
    """``tests/test_registry.py:38-47`` on both packages: equal summaries
    and row lists."""
    seen = {}
    for name, mod in BOTH:
        m = mod.WorkManifest(tmp_path / f"{name}.db", template="experiment")
        m.ingest(["x.png", "y.png", "z.png"], condition_name="cond_a", batch_name="batch_1")
        m.record_error("x.png", "boom")
        m.record_result("y.png", [], empty=True)
        m.record_result("z.png", [{"mask": {"encoding_type": "compressed_binary"}, "area": 3}])
        s = m.summary()
        assert s["total"] == 3 and s["completed"] == 2 and s["errors"] == 1 and s["empty"] == 1
        assert s["with_masks"] == 1 and s["with_deformability"] == 0
        assert m.pending() == []  # errored rows are not retried silently
        seen[name] = (s, m.list_rows(), m.list_rows(limit=1), m.list_tables())
        assert seen[name][1][0]["error"] == "boom"
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("template", sorted(TABLE_TEMPLATES))
def test_all_templates_create(tmp_path, template):
    """``tests/test_registry.py:50-52``: each template, the same tables and
    indexes as the JAX package's, and an unknown template refused."""
    for name, mod in BOTH:
        mod.WorkManifest(tmp_path / f"{name}.db", table="imgs", template=template).close()
    assert _schema(tmp_path / "port.db") == _schema(tmp_path / "jax.db")
    assert TABLE_TEMPLATES == jmanifest.TABLE_TEMPLATES
    with pytest.raises(ValueError, match="unknown template"):
        WorkManifest(tmp_path / "x.db", template="bogus")


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_to_result_row_schema(seed):
    """``tests/test_registry.py:55-68``: the DB-facing keys, box and
    confidence, equal to the JAX function's, with and without a mask."""
    rng = np.random.default_rng(seed)
    metrics = _metrics(rng)
    box = rng.uniform(0, 100, 4).astype(np.float32)
    mask = encode_binary_mask(rng.random((9, 7)) > 0.5)
    for kw in (dict(box=box, confidence=np.float32(0.9)), dict(mask_encoded=mask), {}):
        row = tmanifest.metrics_to_result_row(metrics, **kw)
        assert row == jmanifest.metrics_to_result_row(metrics, **kw)
        assert set(RESULT_KEYS) <= set(row)
    row = tmanifest.metrics_to_result_row(metrics, box=[1, 2, 3, 4], confidence=0.9)
    assert row["box"] == {"x_min": 1.0, "y_min": 2.0, "x_max": 3.0, "y_max": 4.0}
    assert row["confidence"] == 0.9


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_manifest_file_reads_back_through_either_package(tmp_path, writer, reader):
    """A sqlite manifest written by one package (ingest, results with
    encoded masks, an error, an empty row) reads back identically through
    the other: pending, results, summary, rows, tables."""
    mods = dict(BOTH)
    rng = np.random.default_rng(4)
    db = tmp_path / "m.db"
    w = mods[writer].WorkManifest(db, table="runs", template="time_series")
    paths = [f"frames/f{i}.png" for i in range(5)]
    w.ingest(paths, frame_index=3, timestamp=1.5)
    rows = [mods[writer].metrics_to_result_row(
        _metrics(rng), mask_encoded=encode_binary_mask(rng.random((12, 10)) > 0.4),
        box=rng.uniform(0, 50, 4), confidence=float(rng.random())) for _ in range(2)]
    w.record_result(paths[0], rows)
    w.record_result(paths[1], [], empty=True)
    w.record_error(paths[2], "decode failed")
    want = (w.pending(), w.get_results(paths[0]), w.summary(), w.list_rows(), w.list_tables())
    w.close()
    r = mods[reader].WorkManifest(db, table="runs", template="time_series")
    got = (r.pending(), r.get_results(paths[0]), r.summary(), r.list_rows(), r.list_tables())
    assert got == want
    assert got[0] == paths[3:]
    back = decode_binary_mask(got[1][1]["mask"])
    assert back.shape == (12, 10)


# ---------------------------------------------------------- process_pending


def _pipes():
    jp = jengine.CellSegmentationPipeline(
        sam_config=jax_tiny(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS))
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS))
    return jp, tp


@pytest.fixture(scope="module")
def pending_runs(tmp_path_factory):
    """Both packages' ``process_pending`` over 3 PNG frames and a missing
    file, each on its own manifest; then a second pass of each."""
    d = tmp_path_factory.mktemp("pending")
    rng = np.random.default_rng(12)
    imgs = []
    for i in range(3):
        p = d / f"img_{i}.png"
        write_png(p, make_cell_image(rng))
        imgs.append(str(p))
    paths = imgs + [str(d / "missing.png")]  # never written: the error path
    out = {"imgs": imgs, "d": d}
    for (name, mod), pipe, nodes in zip(BOTH, _pipes(), (jnodes, tnodes)):
        m = mod.WorkManifest(d / f"{name}.db")
        m.ingest(paths)
        out[name] = {"stats": nodes.process_pending(m, pipe),
                     "again": nodes.process_pending(m, pipe), "m": m, "pipe": pipe}
    return out


def test_process_pending_resume(pending_runs):
    """``tests/test_registry.py:88-117`` (slow there): 3 processed, the
    missing file recorded as an error, nothing pending, the rows in the DB
    schema with a full-frame mask; a second pass processes nothing. The
    same stats and summary as the JAX package's."""
    port, jax = pending_runs["port"], pending_runs["jax"]
    assert port["stats"] == jax["stats"]
    assert port["stats"]["processed"] == 3 and port["stats"]["errors"] == 1
    assert port["again"]["processed"] == 0 == jax["again"]["processed"]
    m = port["m"]
    assert m.pending() == []
    assert m.summary() == jax["m"].summary()
    errors = [r for r in m.list_rows() if r["error"]]
    assert len(errors) == 1 and errors[0]["minio_path"].endswith("missing.png")
    res = m.get_results(pending_runs["imgs"][0])
    assert res
    assert decode_binary_mask(res[0]["mask"]).shape == (96, 128)
    assert "confidence" in res[0] and "box" in res[0]


def test_process_pending_matches_jax(pending_runs):
    """Each stored row against the JAX row of the same image: the same
    cells, boxes and confidences within 1e-4 / 1e-3; masks differing in few
    pixels, areas by at most those pixels, and a cell whose mask agrees has
    the same values (``tests/test_torch_directory.py:113-118``)."""
    same = 0
    for path in pending_runs["imgs"]:
        got = pending_runs["port"]["m"].get_results(path)
        want = pending_runs["jax"]["m"].get_results(path)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in ("x_min", "y_min", "x_max", "y_max"):
                assert g["box"][k] == pytest.approx(w["box"][k], rel=1e-4, abs=1e-3)
            assert g["confidence"] == pytest.approx(w["confidence"], rel=1e-4, abs=1e-4)
            gm, wm = decode_binary_mask(g["mask"]), decode_binary_mask(w["mask"])
            diff = int((gm != wm).sum())
            assert diff <= 0.01 * gm.size
            assert abs(g["area"] - w["area"]) <= diff
            if diff == 0:
                same += 1
                for key in RESULT_KEYS:
                    assert g[key] == pytest.approx(w[key], rel=1e-4, abs=1e-3), key
    assert same > 0


def test_process_pending_rows_equal_the_call(pending_runs):
    """Each image's stored rows against ``process_batch_arrays`` of the
    frame alone on the same pipeline: the valid cells, their boxes, scores,
    the 9 DB-facing metrics and the crop placed in the full frame."""
    pipe, m = pending_runs["port"]["pipe"], pending_runs["port"]["m"]
    from yolo_sam_inference_tpu_torch.io.images import load_image

    for path in pending_runs["imgs"]:
        image = load_image(path)
        out = pipe.process_batch_arrays(image[None])
        rows = m.get_results(path)
        kept = np.flatnonzero(out["valid"][0])
        assert len(rows) == len(kept)
        cm = out["mask_crops"].shape[-1]
        for row, k in zip(rows, kept):
            want = tmanifest.metrics_to_result_row(pipe._metrics_row(out["metrics"], 0, k),
                                                   box=out["boxes"][0, k],
                                                   confidence=out["scores"][0, k])
            assert {key: row[key] for key in want} == want
            full = np.zeros(image.shape[:2], bool)
            r0, c0 = out["offsets"][0, k]
            full[r0:r0 + cm, c0:c0 + cm] = out["mask_crops"][0, k]
            np.testing.assert_array_equal(decode_binary_mask(row["mask"]), full)


def test_process_pending_store_masks_off_and_limit(tmp_path):
    """``store_masks=False`` keeps no mask; ``limit`` takes the first rows."""
    rng = np.random.default_rng(13)
    paths = []
    for i in range(2):
        p = tmp_path / f"i{i}.png"
        write_png(p, make_cell_image(rng))
        paths.append(str(p))
    m = WorkManifest(tmp_path / "m.db")
    m.ingest(paths)
    pipe = _pipes()[1]
    assert tnodes.process_pending(m, pipe, limit=1, store_masks=False)["processed"] == 1
    assert m.pending() == paths[1:]
    assert all("mask" not in r for r in m.get_results(paths[0]))


# ------------------------------------------------------------------- viewer


def _png_array(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def test_render_row_image_matches_jax():
    """The port's numpy rendering against the JAX viewer's PIL one: the
    green mask overlay and the red box outlines equal pixel for pixel, but
    for the band where PIL writes the label above each box (the port lists
    those values in the table); a mask of another shape is skipped."""
    rng = np.random.default_rng(8)
    img = make_cell_image(rng)
    masks = [rng.random(img.shape[:2]) > 0.7, np.zeros(img.shape[:2], bool)]
    masks[1][40:60, 70:90] = True
    results = [
        {"mask": encode_binary_mask(masks[0]), "box": {"x_min": 10, "y_min": 20, "x_max": 50,
                                                       "y_max": 70},
         "confidence": 0.8, "deformability": 0.1},
        {"mask": encode_binary_mask(masks[1]), "box": {"x_min": 60, "y_min": 35, "x_max": 127,
                                                       "y_max": 95}},
        {"mask": encode_binary_mask(np.ones((5, 5), bool)), "box": {"x_min": -5, "y_min": 80,
                                                                  "x_max": 3, "y_max": 99}},
    ]
    got = _png_array(tviewer.render_row_image(img, results))
    want = _png_array(jviewer.render_row_image(img, results))
    keep = np.ones(img.shape[:2], bool)
    keep[10:22, 10:130] = False  # the first box's label
    np.testing.assert_array_equal(got[keep], want[keep])
    assert (got[20, 10:51] == (255, 0, 0)).all() and (got[70, 10:51] == (255, 0, 0)).all()
    assert (got[80, 0:4] == (255, 0, 0)).all() and (got[80:96, 3] == (255, 0, 0)).all()


def test_result_viewer_report(pending_runs, tmp_path):
    """``tests/test_registry.py:120-135``: the static report of the processed
    manifest, with a rendered image a completed row."""
    out = tviewer.build_report(pending_runs["port"]["m"], tmp_path / "report.html")
    html = out.read_text()
    assert "Result viewer" in html
    assert html.count("data:image/png;base64,") == 3
    assert "3/4 complete" in html


def _serve(make_manifest, tables, **kw):
    server = tviewer.serve_viewer(make_manifest, tables, "127.0.0.1", 0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read().decode()


def test_result_viewer_serve_live(tmp_path):
    """``tests/test_registry.py:138-187``: the table picker, the row list
    and the on-demand row render over the sqlite backend; an unknown table
    is a 404."""
    rng = np.random.default_rng(9)
    p = tmp_path / "img.png"
    img = make_cell_image(rng)
    write_png(p, img)
    m = WorkManifest(tmp_path / "m.db")
    m.ingest([str(p)])
    mask = np.zeros(img.shape[:2], bool)
    mask[10:30, 10:30] = True
    row = tmanifest.metrics_to_result_row(_metrics(rng), box=[10, 10, 30, 30], confidence=0.8)
    row["deformability"] = 0.1
    row["mask"] = encode_binary_mask(mask)
    m.record_result(str(p), [row])
    m.close()
    server, base = _serve(lambda table: WorkManifest(tmp_path / "m.db", table=table), ["images"])
    try:
        assert '<a href="/t/images">' in _get(base + "/")
        tbl = _get(base + "/t/images")
        assert "1/1 complete" in tbl and "img.png" in tbl
        rowp = _get(base + f"/t/images/row?path={quote(str(p), safe='')}")
        assert "data:image/png;base64," in rowp  # on-demand render happened
        assert "<td>0.1</td>" in rowp  # deformability cell
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/t/nope")
        assert e.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


SCRIPT = "<script>alert(1)</script>"


class _MarkupManifest:
    """A manifest whose table name, path, error and cell values hold markup."""

    table = f"t{SCRIPT}"

    def __init__(self, img_path):
        self.path = str(img_path)

    def list_rows(self, limit=20):
        return [{"minio_path": self.path, "empty": False, "has_results": True,
                 "error": f"bad {SCRIPT}"}][:limit]

    def get_results(self, path):
        return [{"deformability": SCRIPT, "area": f"<b>{SCRIPT}</b>", "confidence": 0.5}]

    def summary(self):
        return {"table": self.table, "total": 1, "completed": 1, "errors": 1, "empty": 0,
                "percent_complete": 100.0}

    def close(self):
        pass


def test_viewer_escapes_markup(tmp_path):
    """F4: the JAX viewer writes a path, a table name, an error and a cell
    value holding ``<script>`` into its pages raw; the port escapes each,
    in ``build_report``, the row list, the row page and the table picker,
    and quotes the links' paths."""
    img_path = tmp_path / f"cell{SCRIPT.replace('/', '')}.png"
    write_png(img_path, make_cell_image(np.random.default_rng(2)))
    m = _MarkupManifest(img_path)
    pages = {"report": tviewer.build_report(m, tmp_path / "r.html").read_text(),
             "table": tviewer._table_page(m, m.table, 10),
             "row": tviewer._row_page(m, m.table, m.path, tviewer._fs_fetch)}
    jax_pages = [jviewer.build_report(m, tmp_path / "j.html").read_text(),
                 jviewer._table_page(m, m.table, 10)]
    assert all("<script>" in page for page in jax_pages)  # F4 in the JAX viewer
    for name, page in pages.items():
        assert "<script>" not in page and "&lt;script&gt;" in page, name
        assert "<b>" not in page, name
    assert "data:image/png;base64," in pages["row"]
    assert f'href="/t/{quote(m.table, safe="")}/row?path={quote(m.path, safe="")}"' \
        in pages["table"]
    server, base = _serve(lambda table: m, [m.table])
    try:
        pages = [_get(base + "/"), _get(base + f"/t/{quote(m.table, safe='')}"),
                 _get(base + f"/t/{quote(m.table, safe='')}/row?path={quote(m.path, safe='')}")]
    finally:
        server.shutdown()
        server.server_close()
    for page in pages:
        assert "<script>" not in page and "&lt;script&gt;" in page
    assert "data:image/png;base64," in pages[2]


# ------------------------------------------------------------------ readout


def _batch_tree(root, seed):
    """Three batch folders of mixed tables: ints, floats, text, a column one
    file lacks, and a file with a ``batch`` column of its own."""
    rng = np.random.default_rng(seed)
    for i in (1, 2, 3):
        d = root / f"batch_{i}"
        d.mkdir(parents=True)
        n = int(rng.integers(2, 5))
        frame = {"image_name": [f"im_{i}_{j}.png" for j in range(n)],
                 "area": rng.integers(10, 500, n), "deformability": rng.random(n)}
        if i == 2:
            frame["extra"] = rng.integers(0, 9, n)
        if i == 3:
            frame["batch"] = ["old"] * n
        pd.DataFrame(frame).to_csv(d / "batch_data.csv", index=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_local_batches(tmp_path, seed):
    """``tests/test_registry.py:190-200`` on both packages: the combined CSV
    byte for byte the JAX function's, ``batch`` after each file's columns;
    the rows returned as dicts equal to the JAX DataFrame's records."""
    for name in ("jax", "port"):
        _batch_tree(tmp_path / name, seed)
    want = jreadout.combine_local_batches(tmp_path / "jax")
    got = treadout.combine_local_batches(tmp_path / "port")
    assert (tmp_path / "port" / "combined_output.csv").read_bytes() == \
        (tmp_path / "jax" / "combined_output.csv").read_bytes()
    assert len(got) == len(want)
    assert {r["batch"] for r in got} == {"batch_1", "batch_2", "batch_3"}
    assert list(got[0]) == list(want.columns)
    records = want.to_dict("records")
    for g, w in zip(got, records):
        for key, value in w.items():
            if isinstance(value, float) and np.isnan(value):
                assert np.isnan(g[key]), key
            else:
                assert g[key] == value, key
    with pytest.raises(FileNotFoundError):
        treadout.combine_local_batches(tmp_path / "port" / "batch_1")


def test_batch_readout_cli(tmp_path, capsys):
    """The CLI: the same output line and file as the JAX one, and the same
    exit code without ``--root``."""
    outs = {}
    for name, cli in (("jax", jreadout_cli), ("port", treadout_cli)):
        _batch_tree(tmp_path / name, 3)
        assert cli.main(["--root", str(tmp_path / name), "--output",
                         str(tmp_path / f"{name}.csv")]) == 0
        outs[name] = capsys.readouterr().out
        assert cli.main(["--pattern", "x"]) == 2
        outs[name] += capsys.readouterr().out
    assert outs["port"] == outs["jax"] and "combined" in outs["port"]
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_manifest_cli_roundtrip(tmp_path, capsys):
    """``tests/test_apps_misc.py:14-40`` on both CLIs: the same lines (paths
    under each run's own folder) and exit codes."""
    rng = np.random.default_rng(6)
    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        src = tmp_path / name / "imgs"
        (src / "sub").mkdir(parents=True)
        for i in range(3):
            write_png(src / ("sub" if i == 2 else "") / f"i{i}.png", make_cell_image(rng))
        db = str(tmp_path / name / "m.db")
        lines, rcs = [], []
        for argv in (["create"], ["add", "--source-dir", str(src)], ["summary"], ["pending"],
                     ["list", "--limit", "2"], ["add"]):
            rcs.append(cli.main(["--db", db, "--template", "experiment", *argv]))
            lines.append(capsys.readouterr().out.replace(str(tmp_path / name), "ROOT"))
        outs[name] = (rcs, lines)
    assert outs["port"] == outs["jax"]
    rcs, lines = outs["port"]
    assert rcs == [0, 0, 0, 0, 0, 2]
    assert "ingested 3 paths" in lines[1]
    summary = json.loads(lines[2])
    assert summary["total"] == 3 and summary["completed"] == 0
    assert len(lines[3].strip().splitlines()) == 3 and len(lines[4].strip().splitlines()) == 2


# ----------------------------------------------------------------- postgres


def test_postgres_manifest_full_flow(monkeypatch):
    """``tests/test_gated_adapters.py:52-84`` on both adapters, each over its
    own fake store: the same database, index, pending lists and summary."""
    seen = {}
    for name, mod in (("jax", jpostgres), ("port", tpostgres)):
        store = FakePgStore()
        monkeypatch.setitem(sys.modules, "psycopg2", make_fake_psycopg2(store))
        mod.ensure_database("newdb")
        m = mod.PostgresManifest(table="images", template="experiment")
        got = [m.ingest(["a.png", "b.png", "c.png"]), m.ingest(["b.png", "d.png"]),
               len(store.table("images")), m.pending(), m.pending(limit=2)]
        m.record_result("a.png", [{"area": 10, "deformability": 0.2}])
        m.record_result("b.png", [], empty=True)
        m.record_result("c.png", [{"area": 5}])
        m.record_error("d.png", "boom")
        got += [m.pending(), m.summary(), "newdb" in store.databases,
                sorted(store.indexes), m.get_results("a.png"), m.list_rows(limit=10)]
        seen[name] = got
    assert seen["port"] == seen["jax"]
    s = seen["port"][6]
    assert (s["total"], s["completed"], s["errors"], s["empty"], s["with_deformability"]) == \
        (4, 3, 1, 1, 1)
    assert s["percent_complete"] == pytest.approx(75.0)


def test_postgres_backed_result_viewer(pg, tmp_path):
    """``tests/test_gated_adapters.py:87-126``: the viewer's table picker,
    row list and row render through the Postgres adapter."""
    img_path = tmp_path / "cell.png"
    write_png(img_path, make_cell_image(np.random.default_rng(14)))
    m = tpostgres.PostgresManifest(table="results_a")
    tpostgres.PostgresManifest(table="results_b")
    m.ingest([str(img_path), "pending.png"])
    m.record_result(str(img_path), [{"deformability": 0.25, "area": 120, "circularity": 0.8,
                                     "ch_area": 130, "mean_brightness": 88.0, "confidence": 0.9,
                                     "box": {"x_min": 5, "y_min": 5, "x_max": 40, "y_max": 40}}])
    assert {"results_a", "results_b"} <= set(m.list_tables())
    rows = m.list_rows(limit=10)
    assert [r["minio_path"] for r in rows] == [str(img_path), "pending.png"]
    assert rows[0]["has_results"] and not rows[1]["has_results"]
    assert m.get_results("pending.png") is None
    tbl_html = tviewer._table_page(m, "results_a", limit=10)
    assert "1/2 complete" in tbl_html and "pending.png" in tbl_html
    row_html = tviewer._row_page(m, "results_a", str(img_path), tviewer._fs_fetch)
    assert "data:image/png;base64," in row_html and "<td>0.25</td>" in row_html


def test_postgres_ingest_from_tracking_prefix_and_extensions(monkeypatch):
    """``tests/test_gated_adapters.py:129-143`` on both adapters."""
    seen = {}
    for name, mod in (("jax", jpostgres), ("port", tpostgres)):
        store = FakePgStore()
        monkeypatch.setitem(sys.modules, "psycopg2", make_fake_psycopg2(store))
        store.tables["minio_tracking.objects"] = [
            {"object_path": "runA/f1.png"}, {"object_path": "runA/f2.TIFF"},
            {"object_path": "runA/notes.txt"}, {"object_path": "runB/f3.png"}]
        m = mod.PostgresManifest(table="work")
        seen[name] = [m.ingest_from_tracking("runA/"), m.pending(),
                      m.ingest_from_tracking("runA/")]
    assert seen["port"] == seen["jax"] == [2, ["runA/f1.png", "runA/f2.TIFF"], 0]


def test_postgres_error_then_retry_via_record_result(pg):
    """``tests/test_gated_adapters.py:146-154``."""
    m = tpostgres.PostgresManifest()
    m.ingest(["x.png"])
    m.record_error("x.png", "transient")
    assert m.pending() == []
    m.record_result("x.png", [{"area": 1}])
    assert m.summary()["errors"] == 0
    m.close()


def test_psycopg2_missing_raises_clear_error(monkeypatch):
    """``tests/test_gated_adapters.py:157-162``: the JAX adapter's error."""
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    with pytest.raises(RuntimeError, match="psycopg2 is not installed") as got:
        tpostgres._connect()
    with pytest.raises(RuntimeError) as want:
        jpostgres._connect()
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------------- minio


def test_combine_minio_batches_fetch_and_upload(minio_store):
    """``tests/test_gated_adapters.py:247-269`` on both packages: the same
    rows and the same uploaded bytes; a re-run is idempotent."""
    minio_store.objects[("erb-g07", "run/batch_001/batch_data.csv")] = \
        b"area,deformability\n10,0.1\n"
    minio_store.objects[("erb-g07", "run/batch_002/batch_data.csv")] = \
        b"area,deformability\n20,0.2\n30,0.3\n"
    minio_store.objects[("erb-g07", "run/batch_002/other.txt")] = b"ignore"
    want = jreadout.combine_minio_batches(bucket="erb-g07", prefix="run/")
    up = minio_store.objects.pop(("erb-g07", "run/combined_output.csv"))
    got = treadout.combine_minio_batches(bucket="erb-g07", prefix="run/")
    assert got == want.to_dict("records")
    assert sorted({r["batch"] for r in got}) == ["batch_001", "batch_002"]
    assert minio_store.objects[("erb-g07", "run/combined_output.csv")] == up
    assert len(treadout.combine_minio_batches(bucket="erb-g07", prefix="run/",
                                              upload=False)) == 3


@pytest.mark.parametrize("channels", [3, 1, 4, 2])
def test_minio_fetcher_decodes_bucket_object_paths(minio_store, channels):
    """``tests/test_gated_adapters.py:272-287``: a ``bucket/object`` path
    (URL-encoded) decoded by the port's decoders to RGB, as the JAX fetcher's
    ``PIL.Image.convert("RGB")`` gives it, for RGB, gray, RGBA and gray +
    alpha PNGs."""
    rng = np.random.default_rng(channels)
    shape = (6, 8) if channels == 1 else (6, 8, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    minio_store.objects[("erb-g07", "frames/f 1.png")] = png_bytes(img)
    got = tnodes.minio_fetcher(endpoint="fake:9000")("erb-g07/frames/f%201.png")
    want = jnodes.minio_fetcher(endpoint="fake:9000")("erb-g07/frames/f%201.png")
    assert got.shape == (6, 8, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
