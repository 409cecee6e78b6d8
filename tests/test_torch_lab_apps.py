"""The port's lab apps against the JAX package's, on the CPU: the browser ROI
picker (``web/app.py``), the cv2 picker (``gate/picker.py``) and the project
runner's ``--interactive-roi`` / ``--cv2-roi``, the scatter plot, the
training-data builder, ``tiff2png``, the example project, and
``io/images.load_image(grayscale=)``.

Mirrors ``tests/test_web_roi.py``, the cv2 picker cases of
``tests/test_apps_misc.py`` (with a fake cv2 module) and the scatter,
training-data and tiff2png cases of ``tests/test_tools.py``. Where the JAX
app writes a PNG with PIL and the port with its own writer, the gate is the
decoded pixels, not the bytes; CSVs and the scatter's data are compared
value for value.
"""

import base64
import importlib
import json
import re
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from synth import make_cell_image
from yolo_sam_inference_tpu.apps import deformability_training_data as jtrain
from yolo_sam_inference_tpu.apps import make_example_project as jexample
from yolo_sam_inference_tpu.apps import plot_scatter as jscatter
from yolo_sam_inference_tpu.apps import tiff2png as jtiff2png
from yolo_sam_inference_tpu.io import images as jimages
from yolo_sam_inference_tpu.web import app as jweb
from yolo_sam_inference_tpu_torch import reporting as treporting
from yolo_sam_inference_tpu_torch.apps import deformability_training_data as ttrain
from yolo_sam_inference_tpu_torch.apps import make_example_project as texample
from yolo_sam_inference_tpu_torch.apps import plot_scatter as tscatter
from yolo_sam_inference_tpu_torch.apps import project_inference as tproject
from yolo_sam_inference_tpu_torch.apps import tiff2png as ttiff2png
from yolo_sam_inference_tpu_torch.bench.common import write_png
from yolo_sam_inference_tpu_torch.io import images as timages
from yolo_sam_inference_tpu_torch.io.png_native import decode_png
from yolo_sam_inference_tpu_torch.io.tiff import write_tiff
from yolo_sam_inference_tpu_torch.utils.image_utils import save_optimized_tiff
from yolo_sam_inference_tpu_torch.web.app import (
    RoiSession,
    get_roi_coordinates_web,
    pick_condition_image,
    run_server,
)

PORTS = (19591, 19592, 19593, 19594)  # apart from tests/test_web_roi.py's


def _pixels(path):
    from PIL import Image

    return np.asarray(Image.open(path))


# -------------------------------------------------------- load_image(gray)


@pytest.mark.parametrize("form", ["gray png", "rgb png", "uint16 tiff", "rgb tiff"])
def test_load_image_grayscale_matches_jax(tmp_path, form):
    rng = np.random.default_rng(60)
    if form == "gray png":
        path, img = tmp_path / "a.png", rng.integers(0, 256, (20, 30), dtype=np.uint8)
        write_png(path, img)
    elif form == "rgb png":
        path, img = tmp_path / "a.png", rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
        write_png(path, img)
    elif form == "uint16 tiff":
        path, img = tmp_path / "a.tiff", rng.integers(0, 65536, (20, 30), dtype=np.uint16)
        write_tiff(path, img)
    else:
        path, img = tmp_path / "a.tif", rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
        write_tiff(path, img)
    got = timages.load_image(path, grayscale=True)
    assert got.dtype == np.uint8 and got.shape == (20, 30)
    np.testing.assert_array_equal(got, jimages.load_image(path, grayscale=True))
    np.testing.assert_array_equal(timages.load_image(path), jimages.load_image(path))


# ------------------------------------------------- mirrors of test_web_roi


@pytest.fixture
def condition_tree(tmp_path):
    rng = np.random.default_rng(0)
    for cond in ("cond_x", "cond_y"):
        d = tmp_path / cond / "batch_1"
        d.mkdir(parents=True)
        write_png(d / "img_0.png", make_cell_image(rng))
        write_png(d / "something_background.png", make_cell_image(rng))
    ff = tmp_path / "cond_x" / "full_frames"
    ff.mkdir()
    write_png(ff / "frame.png", make_cell_image(rng))
    return tmp_path


def test_pick_condition_image_prefers_full_frames(condition_tree):
    p = pick_condition_image(condition_tree / "cond_x")
    assert "full_frames" in str(p)
    p2 = pick_condition_image(condition_tree / "cond_y")
    assert "background" not in p2.name
    for cond in ("cond_x", "cond_y"):
        assert pick_condition_image(condition_tree / cond) == \
            jweb.pick_condition_image(condition_tree / cond)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def _wait_up(base):
    for _ in range(100):
        try:
            return _get(base + "/health")
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(base)


def test_full_roi_flow(condition_tree, tmp_path):
    """The flow, and the served image's pixels those of the condition's
    frame (the JAX app encodes the same pixels with PIL)."""
    out = tmp_path / "out"
    port = PORTS[0]
    seen = {}

    def client():
        base = f"http://localhost:{port}"
        _wait_up(base)
        status, body = _get(base + "/")
        seen["page"] = status == 200 and b"Select ROI" in body
        status, img = _get(base + "/image?condition=cond_x")
        seen["png"] = img
        _, resp = _post(base + "/confirm_roi", {"condition": "cond_x", "x_min": 10,
                                                "x_max": 90, "y_min": 5, "y_max": 60})
        seen["next"] = resp["next"]
        _, resp = _post(base + "/confirm_roi", {"condition": "cond_y", "x_min": 1, "x_max": 2,
                                                "y_min": 3, "y_max": 4})
        seen["last"] = resp["next"]

    t = threading.Thread(target=client)
    t.start()
    rois = get_roi_coordinates_web([condition_tree / "cond_x", condition_tree / "cond_y"], out,
                                   port=port, timeout=30)
    t.join()
    assert seen["page"] and seen["next"] == "cond_y" and seen["last"] is None
    assert seen["png"][:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(seen["png"]),
                                  jimages.load_image(condition_tree / "cond_x" / "full_frames" /
                                                     "frame.png"))
    assert rois["cond_x"] == {"x_min": 10, "x_max": 90, "y_min": 5, "y_max": 60}
    assert rois["cond_y"]["x_max"] == 2
    assert json.loads((out / "roi_coordinates.json").read_text()) == rois


def test_condition_param_escaped_and_validated(condition_tree, tmp_path):
    """Unknown conditions are rejected; a known hostile name is escaped per
    context, the page the JAX app's byte for byte."""
    from urllib.parse import quote

    hostile = "<img src=x onerror=alert(1)>"
    image = pick_condition_image(condition_tree / "cond_y")
    session = RoiSession({hostile: image}, tmp_path / "roi.json")
    server = run_server(session, port=PORTS[1])
    jserver = jweb.run_server(jweb.RoiSession({hostile: image}, tmp_path / "jroi.json"),
                              port=PORTS[2])
    try:
        base = f"http://localhost:{PORTS[1]}"
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + "/?condition=" + quote("<script>alert(1)</script>"))
        assert exc.value.code == 404
        status, body = _get(base + "/?condition=" + quote(hostile))
        assert status == 200
        assert b"<img src=x onerror" not in body
        assert b"&lt;img src=x onerror" in body
        assert b'condition: "\\u003cimg' in body
        assert body == _get(f"http://localhost:{PORTS[2]}/?condition=" + quote(hostile))[1]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(base + "/confirm_roi",
                  {"condition": "evil", "x_min": 0, "x_max": 1, "y_min": 0, "y_max": 1})
        assert exc.value.code == 404
    finally:
        server.shutdown()
        jserver.shutdown()


def test_bad_confirm_rejected(condition_tree, tmp_path):
    session = RoiSession({"c": pick_condition_image(condition_tree / "cond_y")},
                         tmp_path / "roi.json")
    server = run_server(session, port=PORTS[3])
    try:
        req = urllib.request.Request(f"http://localhost:{PORTS[3]}/confirm_roi",
                                     data=b"not json",
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=10)
        assert exc.value.code == 400
    finally:
        server.shutdown()


def test_project_runner_takes_the_browser_picker(condition_tree, tmp_path):
    """``--interactive-roi --port`` parse (the refusal is gone) and
    ``resolve_rois`` serves the picker until every condition is confirmed."""
    port = PORTS[0] + 10
    args = tproject.parse_args(["--project-dir", str(condition_tree), "--output-dir",
                                str(tmp_path / "out"), "--interactive-roi", "--port",
                                str(port)])
    assert args.interactive_roi and args.port == port
    assert tproject.parse_args(["--project-dir", "p", "--output-dir", "o"]).port == 9487

    def client():
        base = f"http://localhost:{port}"
        try:
            _wait_up(base)
        finally:  # the runner waits with no timeout: always confirm
            for cond in ("cond_x", "cond_y"):
                _post(base + "/confirm_roi", {"condition": cond, "x_min": 3, "x_max": 40,
                                              "y_min": 0, "y_max": 50})

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rois = tproject.resolve_rois(args, ["cond_x", "cond_y"])
    t.join(timeout=30)
    assert not t.is_alive()
    assert rois == {c: {"x_min": 3, "x_max": 40, "y_min": 0, "y_max": 50}
                    for c in ("cond_x", "cond_y")}
    assert json.loads((tmp_path / "out" / "roi_coordinates.json").read_text()) == rois


# ------------------------------------------------- the cv2 picker mirrors


def _cv2_stub(state):
    stub = types.SimpleNamespace()
    stub.EVENT_LBUTTONDOWN = 1
    stub.imread = lambda p: np.zeros((20, 40, 3), np.uint8)
    stub.namedWindow = lambda name: None
    stub.line = lambda *a, **k: None
    stub.imshow = lambda *a, **k: None
    stub.destroyAllWindows = lambda: None
    stub.setMouseCallback = lambda name, cb: state.__setitem__("cb", cb)
    stub.waitKey = lambda ms: next(state["keys"])
    return stub


def _keyscript(state, stub, clicks=((30, 8), (12, 33))):
    def keys():
        cb = state["cb"]
        cb(stub.EVENT_LBUTTONDOWN, clicks[0][0], 5, 0, None)
        yield 0xFF & 0
        cb(stub.EVENT_LBUTTONDOWN, clicks[0][1], 5, 0, None)
        yield ord("r")
        cb(stub.EVENT_LBUTTONDOWN, clicks[1][0], 5, 0, None)
        cb(stub.EVENT_LBUTTONDOWN, clicks[1][1], 5, 0, None)
        yield ord("c")
    return keys()


def test_cv2_roi_picker_interaction(tmp_path, monkeypatch):
    """Two clicks -> (min, max), 'r' resets, 'c' confirms, through a
    scripted cv2 stub (no display here)."""
    write_png(tmp_path / "frame.png", np.zeros((20, 40), np.uint8))
    state = {}
    stub = _cv2_stub(state)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    import yolo_sam_inference_tpu_torch.gate.picker as picker

    importlib.reload(picker)
    state["keys"] = _keyscript(state, stub)
    assert picker.get_roi_coordinates(tmp_path / "frame.png") == (12, 33)


def test_cv2_roi_picker_unreadable_image(tmp_path, monkeypatch):
    stub = types.SimpleNamespace(imread=lambda p: None, EVENT_LBUTTONDOWN=1)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    import yolo_sam_inference_tpu_torch.gate.picker as picker

    importlib.reload(picker)
    with pytest.raises(ValueError, match="Could not read image"):
        picker.get_roi_coordinates(tmp_path / "missing.png")


def test_project_runner_takes_the_cv2_picker(condition_tree, tmp_path, monkeypatch):
    """``--cv2-roi`` parses, and each condition's first image opens the
    picker: its two clicks become the condition's x gate."""
    state = {}
    stub = _cv2_stub(state)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    import yolo_sam_inference_tpu_torch.gate.picker as picker

    importlib.reload(picker)
    opened = []
    real = picker.get_roi_coordinates

    def scripted(path):
        opened.append(Path(path).name)
        state["keys"] = _keyscript(state, stub, ((1, 2), (40, 7)))
        return real(path)

    monkeypatch.setattr(picker, "get_roi_coordinates", scripted)
    args = tproject.parse_args(["--project-dir", str(condition_tree), "--output-dir", "o",
                                "--cv2-roi"])
    rois = tproject.resolve_rois(args, ["cond_x", "cond_y"])
    assert opened == ["img_0.png", "img_0.png"]
    assert rois == {c: {"x_min": 7, "x_max": 40, "y_min": 0, "y_max": 10**9}
                    for c in ("cond_x", "cond_y")}


# ------------------------------------------------- scatter and training data


@pytest.fixture
def fake_run_dir(tmp_path):
    """A run dir with gated_cell_metrics.csv (global and per condition, the
    global one repeating the others' rows) and 1_original_images/ TIFFs."""
    rng = np.random.default_rng(61)
    run = tmp_path / "run"
    (run / "1_original_images").mkdir(parents=True)
    rows = []
    for cond in ("a", "b"):
        for i in range(12):
            save_optimized_tiff(make_cell_image(rng),
                                run / "1_original_images" / f"{cond}_img{i}_original.tiff")
            rows.append({"condition": cond, "image_name": f"{cond}_img{i}.png", "cell_id": 0,
                         "deformability": rng.uniform(0, 0.5),
                         "convex_hull_area": rng.uniform(200, 800), "area": 300,
                         "min_x": int(rng.integers(5, 40)), "max_x": int(rng.integers(50, 90)),
                         "min_y": 30, "max_y": 70})
    df = pd.DataFrame(rows)
    df.to_csv(run / "gated_cell_metrics.csv", index=False)
    (run / "a").mkdir()
    df[df["condition"] == "a"].to_csv(run / "a" / "gated_cell_metrics.csv", index=False)
    return run


def _data(html):
    return json.loads(re.search(r"const DATA = (.*);\n", html).group(1))


@pytest.mark.parametrize("max_points", [2000, 5])
def test_scatter_plot_html(fake_run_dir, tmp_path, max_points):
    """The mirror's checks; the embedded points equal the JAX app's (its
    pandas sample too), each hover crop's pixels its crop's."""
    out = tscatter.create_scatter_plot(fake_run_dir, tmp_path / "t.html",
                                       max_points_per_condition=max_points)
    html = out.read_text()
    assert html.startswith("<!DOCTYPE html>")
    assert "convex_hull_area" in html and "deformability" in html
    assert '"condition": "a"' in html and '"condition": "b"' in html
    assert "data:image/png;base64," in html or '"img":' in html
    want = _data(jscatter.create_scatter_plot(fake_run_dir, tmp_path / "j.html",
                                              max_points_per_condition=max_points).read_text())
    got = _data(html)
    assert len(got) == len(want) == (24 if max_points > 12 else 10)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "img"} == \
            {k: v for k, v in w.items() if k != "img"}
        from PIL import Image
        import io

        np.testing.assert_array_equal(decode_png(base64.b64decode(g["img"])), np.asarray(
            Image.open(io.BytesIO(base64.b64decode(w["img"])))))


def test_scatter_reads_csvs_as_pandas_does(tmp_path):
    """Typed columns, NaN gaps, a CSV without ``condition``, duplicates
    dropped: the rows equal pandas' frame."""
    run = tmp_path / "run"
    (run / "c1").mkdir(parents=True)
    (run / "c1" / "gated_cell_metrics.csv").write_text(
        "image_name,cell_id,deformability,convex_hull_area,area,note\n"
        "x.png,0,0.25,300,12,\nx.png,0,0.25,300,12,\ny.png,1,,310.5,13,hi\n")
    (run / "gated_cell_metrics.csv").write_text(
        "condition,image_name,cell_id,deformability,convex_hull_area\n"
        "c1,x.png,0,0.25,300\nc2,z.png,2,0.5,1e3\n")
    got = tscatter.load_project_data(run)
    want = jscatter.load_project_data(run)
    assert list(got[0]) == list(want.columns)
    assert len(got) == len(want)
    for g, (_, w) in zip(got, want.iterrows()):
        for k in want.columns:
            if pd.isna(w[k]):
                assert isinstance(g[k], float) and np.isnan(g[k]), k
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k].item() if hasattr(
                    w[k], "item") else w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("n", [5, 6, 11, 24, 37])
def test_quantile_groups_are_pandas_qcut(n):
    rng = np.random.default_rng(62 + n)
    values = np.round(rng.uniform(0, 0.5, n), 2 if n > 10 else 6)
    labels = ttrain.GROUP_NAMES
    try:
        want = [None if pd.isna(v) else str(v) for v in
                pd.qcut(values, 5, labels=labels, duplicates="drop")]
    except ValueError as e:
        with pytest.raises(ValueError, match="one fewer"):
            ttrain.quantile_groups(values, labels)
        assert "one fewer" in str(e)
        return
    assert ttrain.quantile_groups(values, labels) == want


def test_training_data_prep(fake_run_dir, tmp_path):
    """The mirror's checks; the metadata and every crop's pixels equal the
    JAX builder's."""
    meta = ttrain.create_training_data(fake_run_dir, tmp_path / "train")
    assert len(meta) > 0
    assert (tmp_path / "train" / "metadata.csv").exists()
    for g in {r["group"] for r in meta}:
        assert g in ttrain.GROUP_NAMES
        assert (tmp_path / "train" / g).is_dir()
    assert (tmp_path / "train" / meta[0]["file"]).exists()
    jmeta = jtrain.create_training_data(fake_run_dir, tmp_path / "jtrain")
    assert (tmp_path / "train" / "metadata.csv").read_bytes() == \
        (tmp_path / "jtrain" / "metadata.csv").read_bytes()
    for f in jmeta["file"]:
        np.testing.assert_array_equal(decode_png((tmp_path / "train" / f).read_bytes()),
                                      _pixels(tmp_path / "jtrain" / f), err_msg=f)


def test_tiff2png(tmp_path):
    rng = np.random.default_rng(63)
    src = tmp_path / "in" / "sub dir"
    src.mkdir(parents=True)
    write_tiff(src / "weird name (1).tiff", rng.integers(0, 255, (20, 30)).astype(np.uint8))
    write_tiff(src / "rgb.tif", rng.integers(0, 255, (12, 9, 3)).astype(np.uint8))
    assert ttiff2png.convert_tree(tmp_path / "in", tmp_path / "out") == 2
    assert jtiff2png.convert_tree(tmp_path / "in", tmp_path / "jout") == 2
    pngs = sorted((tmp_path / "out").rglob("*.png"))
    assert [p.relative_to(tmp_path / "out") for p in pngs] == \
        sorted(p.relative_to(tmp_path / "jout") for p in (tmp_path / "jout").rglob("*.png"))
    assert all("(" not in p.name for p in pngs)
    for p in pngs:
        np.testing.assert_array_equal(decode_png(p.read_bytes()),
                                      _pixels(tmp_path / "jout" / p.relative_to(tmp_path / "out")))
    assert ttiff2png.sanitize_filename("a  b(c)!.tiff") == jtiff2png.sanitize_filename(
        "a  b(c)!.tiff")
    assert ttiff2png.main(["--input-dir", str(tmp_path / "none"), "--output-dir", "o"]) == 2


def test_make_example_project(tmp_path, capsys):
    argv = ["--conditions", "2", "--batches", "2", "--images-per-batch", "2", "--height", "40",
            "--width", "56", "--seed", "3"]
    assert texample.main(["--output-dir", str(tmp_path / "t")] + argv) == 0
    assert jexample.main(["--output-dir", str(tmp_path / "j")] + argv) == 0
    files = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*.png"))
    assert len(files) == 8
    assert files == sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.png"))
    for f in files:
        np.testing.assert_array_equal(decode_png((tmp_path / "t" / f).read_bytes()),
                                      _pixels(tmp_path / "j" / f))


def test_pandas_float_is_pandas_parser():
    """``pandas_float`` reads every repr as pandas' default parser does,
    where ``float()`` differs on many (one ulp)."""
    import io

    rng = np.random.default_rng(64)
    vals = np.concatenate([rng.uniform(0, 1, 3000), rng.uniform(0, 1000, 3000),
                           10.0 ** rng.uniform(-30, 30, 1000)])
    texts = [repr(float(v)) for v in vals] + ["1e3", "-2.5E-3", "0.1", "+7", "1.5e300",
                                              "123456789012345678901.5"]
    want = pd.read_csv(io.StringIO("v\n" + "\n".join(texts) + "\n"))["v"].tolist()
    assert [treporting.pandas_float(t) for t in texts] == want
    assert sum(float(t) != w for t, w in zip(texts, want)) > 100
