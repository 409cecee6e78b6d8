"""The port's micro-batching service (``web/serve.py``) and its bench
(``bench/serve.py``) against the JAX package's, on the CPU.

Both services run a tiny fp32 pipeline from one seed (``sam_tiny_test``,
YOLOv8n at a 64-pixel letterbox, 64x64 ``tests/synth.py`` frames) on
loopback port 0; every request waits with a timeout, and the servers are
shut down in the fixture's finalizer. The JAX ``tests/test_serve.py`` cases
run against the port's service; the response formatters, the decoders and
the channel policy are held against the JAX service's on the same inputs,
with PIL and without it.
"""

import io
import json
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu.web import serve as jserve
from yolo_sam_inference_tpu_torch.bench import serve as bserve
from yolo_sam_inference_tpu_torch.io import images as timages
from yolo_sam_inference_tpu_torch.io.png import png_bytes
from yolo_sam_inference_tpu_torch.io.tiff import write_tiff
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.utils.mask_encoding import decode_binary_mask
from yolo_sam_inference_tpu_torch.web import serve as tserve

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
OPTS = dict(batch_size=4, max_det=8, metric_crop=48, yolo_size=64, nms_candidates=64,
            sam_encoder_size=64)
TIMEOUT = 60  # seconds any request may wait


def _port_pipe():
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS))


def _start(module, pipe):
    server, service = module.serve(pipe, host="127.0.0.1", port=0, max_wait_ms=30.0,
                                   image_shape=(64, 64))
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()

    def close():
        server.shutdown()
        server.server_close()
        service.stop()
        loop.join(timeout=5)
        assert not loop.is_alive()

    return f"http://127.0.0.1:{server.server_address[1]}", service, close


@pytest.fixture(scope="module")
def services(request):
    """The port's service and the JAX service, both on the same seed-0 tiny
    weights, warmed at 64x64."""
    jpipe = jengine.CellSegmentationPipeline(
        sam_config=jax_tiny(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS))
    tpipe = _port_pipe()
    turl, tservice, tclose = _start(tserve, tpipe)
    request.addfinalizer(tclose)
    jurl, jservice, jclose = _start(jserve, jpipe)
    request.addfinalizer(jclose)
    return {"url": turl, "service": tservice, "pipe": tpipe, "jax_url": jurl}


def _post(url, path, body, headers=None, raw=False):
    req = urllib.request.Request(url + path, data=body, method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            data = r.read()
            return r.status, (data if raw else json.loads(data))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pil_png(img, mode=None):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG")
    return buf.getvalue()


PNG = {"Content-Type": "image/png"}


@pytest.fixture(params=["pil", "no_pil"])
def pil(request, monkeypatch):
    """The port's decoders with PIL, and with PIL hidden."""
    if request.param == "no_pil":
        monkeypatch.setattr(timages, "_PILImage", None)
    return request.param


# ------------------------------------------------------------ the JAX cases


def test_healthz_ready_after_warmup(services):
    with urllib.request.urlopen(services["url"] + "/healthz", timeout=TIMEOUT) as r:
        assert r.status == 200
        assert json.loads(r.read())["status"] == "ok"


def test_segment_png_roundtrip(services, pil):
    img = make_cell_image(np.random.default_rng(0), 64, 64)
    status, resp = _post(services["url"], "/segment", _pil_png(img), PNG)
    assert status == 200
    assert set(resp) >= {"num_cells", "boxes", "scores", "cells"}
    assert len(resp["boxes"]) == resp["num_cells"] == len(resp["cells"])
    assert resp["num_cells"] > 0
    assert set(resp["cells"][0]) == set(METRIC_KEYS)


def test_segment_raw_body_and_masks(services):
    img = make_cell_image(np.random.default_rng(1), 64, 64)
    status, resp = _post(services["url"], "/segment?masks=1", img[..., 0].tobytes(),
                         {"Content-Type": "application/octet-stream", "X-Shape": "64x64"})
    assert status == 200 and resp["num_cells"] > 0
    m = resp["masks"][0]
    assert len(m["offset"]) == 2
    decoded = decode_binary_mask(m)
    assert decoded.dtype == bool and decoded.any()


def _parse_bin(buf):
    """The YSB1 record's sections (layout: web/serve.py's docstring)."""
    assert buf[:4] == b"YSB1"
    n, nm, flags = struct.unpack_from("<III", buf, 4)
    (klen,) = struct.unpack_from("<I", buf, 16)
    keys = buf[20:20 + klen].decode().split(",")
    off = 20 + klen
    boxes = np.frombuffer(buf, "<f4", n * 4, off).reshape(n, 4)
    off += n * 16
    scores = np.frombuffer(buf, "<f4", n, off)
    off += n * 4
    metrics = np.frombuffer(buf, "<f4", n * nm, off).reshape(n, nm)
    off += n * nm * 4
    masks = []
    for _ in range(n if flags & 1 else 0):
        oy, ox, h, w, nb = struct.unpack_from("<IIIII", buf, off)
        off += 20
        bits = np.unpackbits(np.frombuffer(zlib.decompress(buf[off:off + nb]), np.uint8))
        masks.append(([oy, ox], bits[:h * w].reshape(h, w).astype(bool)))
        off += nb
    assert off == len(buf)
    return keys, flags, boxes, scores, metrics, masks


def test_segment_binary_response(services, pil):
    """?fmt=bin returns the packed record; values match the JSON path."""
    url = services["url"]
    img = make_cell_image(np.random.default_rng(7), 64, 64)
    _, jresp = _post(url, "/segment?masks=1", _pil_png(img), PNG)
    req = urllib.request.Request(url + "/segment?fmt=bin&masks=1", data=_pil_png(img),
                                 method="POST", headers=PNG)
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.status == 200
        assert r.headers["Content-Type"] == "application/octet-stream"
        buf = r.read()
    keys, flags, boxes, scores, metrics, masks = _parse_bin(buf)
    assert keys == list(METRIC_KEYS) and flags == 1 and len(boxes) == jresp["num_cells"] > 0
    np.testing.assert_allclose(boxes, np.asarray(jresp["boxes"]), rtol=1e-6)
    np.testing.assert_allclose(scores, np.asarray(jresp["scores"]), rtol=1e-6)
    for j, cell in enumerate(jresp["cells"]):
        np.testing.assert_allclose(metrics[j], np.asarray([cell[k] for k in keys], np.float32),
                                   rtol=1e-5, atol=1e-5)
    for (offset, bits), jm in zip(masks, jresp["masks"]):
        assert offset == jm["offset"]
        np.testing.assert_array_equal(bits, decode_binary_mask(jm))


def test_true_color_rejected_on_grayscale_service(services, pil):
    """True RGB never silently collapses: on a grayscale service it is a
    400; replicated RGB still works."""
    rng = np.random.default_rng(8)
    color = rng.integers(0, 255, (64, 64, 3), np.uint8)
    color[..., 1] ^= 0xFF  # genuinely non-replicated
    status, resp = _post(services["url"], "/segment", _pil_png(color), PNG)
    assert status == 400 and "shape" in resp["error"]
    gray = np.repeat(rng.integers(0, 255, (64, 64, 1), np.uint8), 3, -1)
    status, _ = _post(services["url"], "/segment", _pil_png(gray), PNG)
    assert status == 200


def test_rgba_policy():
    norm = tserve.InferenceService._normalize_channels
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 255, (8, 8, 3), np.uint8)
    rgb[..., 1] ^= 0xFF
    opaque = np.dstack([rgb, np.full((8, 8), 255, np.uint8)])
    np.testing.assert_array_equal(norm(opaque), rgb)  # alpha dropped
    rep = np.repeat(rng.integers(0, 255, (8, 8, 1), np.uint8), 3, -1)
    assert norm(rep).shape == (8, 8)  # replicated-RGB collapses
    assert norm(rgb).shape == (8, 8, 3)  # true color passes through
    translucent = opaque.copy()
    translucent[0, 0, 3] = 17
    with pytest.raises(ValueError):
        norm(translucent)


def test_body_size_cap(services, monkeypatch):
    monkeypatch.setattr(tserve, "MAX_BODY_BYTES", 64)
    status, resp = _post(services["url"], "/segment", b"x" * 200, PNG)
    assert status == 413 and "cap" in resp["error"]


def test_concurrent_requests_share_batches(services):
    url, service = services["url"], services["service"]
    rng = np.random.default_rng(2)
    bodies = [_pil_png(make_cell_image(rng, 64, 64)) for _ in range(4)]
    before = dict(service.stats)
    results = [None] * 4
    start = threading.Barrier(4)

    def hit(i):
        start.wait(timeout=TIMEOUT)  # the four posts leave together
        results[i] = _post(url, "/segment", bodies[i], PNG)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT + 5)
        assert not t.is_alive()
    assert all(r[0] == 200 for r in results)
    assert service.stats["requests"] - before["requests"] == 4
    # micro-batching: 4 concurrent requests need fewer than 4 dispatches
    assert service.stats["batches"] - before["batches"] < 4


def test_shape_mismatch_is_400(services):
    status, resp = _post(services["url"], "/segment", _pil_png(np.zeros((32, 32), np.uint8)),
                         PNG)
    assert status == 400 and "shape" in resp["error"]


def test_stats_endpoint(services):
    _post(services["url"], "/segment", _pil_png(np.zeros((64, 64), np.uint8)), PNG)
    with urllib.request.urlopen(services["url"] + "/stats", timeout=TIMEOUT) as r:
        s = json.loads(r.read())
    assert s["batches"] >= 1 and s["mean_batch_fill"] >= 1.0
    assert set(s) == {"requests", "batches", "images_batched", "errors", "abandoned",
                      "mean_batch_fill"}


class _StubPipeline:
    """No device: each batch's outputs carry every image's first pixel in its
    first box, so a request can tell its own row from another's."""

    class options:
        batch_size = 2

    def __init__(self):
        self.calls = 0

    def _dispatch_batch(self, imgs, fetch_masks=True):
        self.calls += 1
        return {"imgs": imgs.copy()}

    def _fetch_outputs(self, h):
        b, k = h["imgs"].shape[0], 4
        boxes = np.zeros((b, k, 4))
        boxes[:, 0, 0] = h["imgs"][:, 0, 0]
        valid = np.zeros((b, k), bool)
        valid[:, 0] = True
        return {"valid": valid, "boxes": boxes, "scores": np.zeros((b, k)),
                "offsets": np.zeros((b, k, 2), int),
                "metrics": {m: np.zeros((b, k)) for m in METRIC_KEYS}, "mask_crops": None}


def test_abandoned_requests_are_dropped():
    """A request that times out is marked abandoned and the collector skips
    it: no batch runs for a client that already hung up."""
    pipe = _StubPipeline()
    svc = tserve.InferenceService(pipe, batch_size=2, max_wait_ms=1.0, image_shape=(8, 8))
    img = np.zeros((8, 8), np.uint8)
    with pytest.raises(TimeoutError):  # the collector is not started yet
        svc.submit(img, want_masks=False, timeout=0.05)
    svc.start()
    try:
        deadline = time.time() + 2
        while svc.stats["abandoned"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert svc.stats["abandoned"] == 1
        assert pipe.calls == 0
        resp = svc.submit(img, want_masks=False, timeout=5)
        assert resp["num_cells"] == 1 and pipe.calls == 1
    finally:
        svc.stop()


def test_requests_get_their_own_rows_under_contention():
    """24 client threads (more than the cores) submit to one collector with
    the interpreter switching threads every microsecond: every request is
    counted and batched once, and each gets its own image's row."""
    pipe = _StubPipeline()
    svc = tserve.InferenceService(pipe, batch_size=2, max_wait_ms=0.5, image_shape=(8, 8))
    svc.start()
    got, errors = {}, []
    switch = sys.getswitchinterval()

    def client(i):
        try:
            resp = svc.submit(np.full((8, 8), i, np.uint8), want_masks=False, timeout=30)
            got[i] = resp["boxes"][0][0]
        except Exception as e:  # a failed request fails the test below
            errors.append(e)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(1, 25)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=40)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        svc.stop()
    assert not errors
    assert got == {i: float(i) for i in range(1, 25)}
    assert svc.stats["requests"] == svc.stats["images_batched"] == 24
    assert svc.stats["batches"] == pipe.calls >= 12


def test_timeout_is_504(monkeypatch):
    """A request the collector does not answer in time gets a 504 (the JAX
    handler catches ``TimeoutError``, an ``OSError``, as a 400 first)."""
    svc = tserve.InferenceService(_StubPipeline(), batch_size=2, image_shape=(8, 8),
                                  request_timeout_s=0.2)  # the collector is never started
    server = tserve._Server(("127.0.0.1", 0), tserve._make_handler(svc))
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    try:
        status, resp = _post(f"http://127.0.0.1:{server.server_address[1]}", "/segment",
                             bytes(64), {"Content-Type": "application/octet-stream",
                                         "X-Shape": "8x8"})
    finally:
        server.shutdown()
        server.server_close()
        loop.join(timeout=5)
    assert status == 504 and "timed out" in resp["error"]
    assert svc.stats["requests"] == 1


def test_warmup_refuses_a_running_collector():
    svc = tserve.InferenceService(_StubPipeline(), batch_size=2, image_shape=(8, 8))
    svc.start()
    try:
        with pytest.raises(RuntimeError, match="before start"):
            svc.warmup()
    finally:
        svc.stop()


# ------------------------------------------------------- against the JAX code


def _outputs(seed, masks):
    """A batch's host outputs as ``_fetch_outputs`` gives them (4 images,
    6 slots, 12 x 12 crops), image 3 with no valid cell."""
    rng = np.random.default_rng(seed)
    valid = rng.random((4, 6)) < 0.6
    valid[3] = False
    return {"valid": valid,
            "boxes": rng.uniform(0, 64, (4, 6, 4)).astype(np.float32),
            "scores": rng.random((4, 6)).astype(np.float32),
            "offsets": rng.integers(0, 50, (4, 6, 2)).astype(np.int32),
            "metrics": {k: (rng.uniform(0, 500, (4, 6)) if k in INT_METRIC_KEYS
                            else rng.random((4, 6))).astype(np.float32) for k in METRIC_KEYS},
            "mask_crops": rng.random((4, 6, 12, 12)) < 0.5 if masks else None}


@pytest.mark.parametrize("image", [0, 1, 3])
@pytest.mark.parametrize("masks", [True, False])
def test_formatters_match_jax(image, masks):
    """The same outputs dict gives the JAX service's JSON and the same bytes
    of the binary record, with and without masks (image 3 has no cell)."""
    out = _outputs(image, masks)
    for want in (True, False):
        assert tserve.InferenceService._format_response(out, image, want) == \
            jserve.InferenceService._format_response(out, image, want)
        assert tserve.InferenceService._format_response_bin(out, image, want) == \
            jserve.InferenceService._format_response_bin(out, image, want)


def _bodies():
    """Request bodies by name: PNGs in PIL's encoding (its adaptive filters),
    a TIFF from the port's writer, a JPEG and bytes no decoder takes."""
    rng = np.random.default_rng(11)
    gray = make_cell_image(rng, 36, 48)[..., 0]
    rgb = rng.integers(0, 256, (36, 48, 3), np.uint8)
    alpha = rng.integers(0, 256, (36, 48), np.uint8)
    opaque = np.full((36, 48), 255, np.uint8)
    tiff = io.BytesIO()
    return {
        "L": _pil_png(gray),
        "LA": _pil_png(np.dstack([gray, alpha]), "LA"),
        "RGB": _pil_png(rgb),
        "replicated RGB": _pil_png(np.repeat(gray[..., None], 3, -1)),
        "opaque RGBA": _pil_png(np.dstack([rgb, opaque]), "RGBA"),
        "translucent RGBA": _pil_png(np.dstack([rgb, alpha]), "RGBA"),
        "opaque RGBA (port writer, Paeth)": png_bytes(np.dstack([rgb, opaque]), 4),
        "TIFF": ("tiff", gray),
        "RGB TIFF": ("tiff", rgb),
    }


def _decode_and_normalize(module, body):
    """(array, None) or (None, exception type) of ``_decode_image`` then
    ``_normalize_channels``, as a request thread runs them."""
    try:
        img = module._decode_image(body, {"Content-Type": "image/png"})
        return module.InferenceService._normalize_channels(np.asarray(img, np.uint8)), None
    except (ValueError, OSError) as e:  # the handler's 400
        return None, type(e)


@pytest.mark.parametrize("kind", list(_bodies()))
def test_decoding_matches_jax(kind, pil, tmp_path):
    """The port's decode and channel policy give the JAX service's arrays, or
    a 400 where it gives one, with PIL and without it: mode L stays (H, W);
    alpha is read, not dropped (opaque RGBA is served, translucent refused)."""
    body = _bodies()[kind]
    if isinstance(body, tuple):
        write_tiff(tmp_path / "f.tiff", body[1])
        body = (tmp_path / "f.tiff").read_bytes()
    want, jerr = _decode_and_normalize(jserve, body)
    got, terr = _decode_and_normalize(tserve, body)
    if jerr is not None:
        assert terr is not None, kind
        return
    assert terr is None, (kind, terr)
    assert got.dtype == want.dtype and got.shape == want.shape, kind
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["garbage", "JPEG"])
def test_undecodable_body_is_400(services, pil, kind):
    """A body no decoder takes gets a 400 with the reason; a JPEG needs PIL."""
    if kind == "garbage":
        body = b"\x00\x01 not an image" * 10
    else:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(make_cell_image(np.random.default_rng(3), 64, 64)).save(buf, "JPEG")
        body = buf.getvalue()
    status, resp = _post(services["url"], "/segment", body, {"Content-Type": "image/jpeg"})
    if kind == "JPEG" and pil == "pil":
        assert status == 200
    else:
        assert status == 400 and resp["error"]
        if pil == "no_pil":
            assert "PIL is not installed" in resp["error"]


def test_service_matches_jax_service(services):
    """One frame through both services on the same weights: the same cells,
    and every metric of a cell whose mask is the same pixels agrees (the
    directory path's tolerances, ``tests/test_torch_directory.py``); areas
    differ by at most the differing pixels."""
    img = make_cell_image(np.random.default_rng(5), 64, 64)
    body = _pil_png(img)
    _, tresp = _post(services["url"], "/segment?masks=1", body, PNG)
    _, jresp = _post(services["jax_url"], "/segment?masks=1", body, PNG)
    assert tresp["num_cells"] == jresp["num_cells"] > 0
    np.testing.assert_allclose(tresp["boxes"], jresp["boxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tresp["scores"], jresp["scores"], rtol=1e-4, atol=1e-4)
    same = 0
    for tc, jc, tm, jm in zip(tresp["cells"], jresp["cells"], tresp["masks"], jresp["masks"]):
        diff = int((decode_binary_mask(tm) != decode_binary_mask(jm)).sum())
        assert abs(tc["area"] - jc["area"]) <= diff
        if diff == 0 and tm["offset"] == jm["offset"]:
            same += 1
            for key in METRIC_KEYS:
                np.testing.assert_allclose(tc[key], jc[key], rtol=1e-4, atol=1e-3, err_msg=key)
    assert same > 0


def test_responses_equal_process_batch_arrays(services):
    """Four frames posted at once, raw and PNG, JSON and binary: each
    response's cells and masks equal the rows ``process_batch_arrays`` gives
    the same frame in one batch of the four (ints exact, floats 1e-5), and
    the binary record equals the JSON."""
    rng = np.random.default_rng(6)
    frames = np.stack([make_cell_image(rng, 64, 64)[..., 0] for _ in range(4)])
    ref = services["pipe"].process_batch_arrays(frames)
    raw = {"Content-Type": "application/octet-stream", "X-Shape": "64x64"}
    jobs = [(i, fmt, body) for i in range(4) for fmt, body in
            (("json", (frames[i].tobytes(), raw)), ("bin", (png_bytes(frames[i], 1), PNG)))]
    results = {}

    def hit(i, fmt, body):
        q = "?masks=1" + ("&fmt=bin" if fmt == "bin" else "")
        results[i, fmt] = _post(services["url"], "/segment" + q, body[0], body[1],
                                raw=fmt == "bin")

    threads = [threading.Thread(target=hit, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT + 5)
        assert not t.is_alive()
    cells = 0
    for i in range(4):
        (s1, resp), (s2, buf) = results[i, "json"], results[i, "bin"]
        assert s1 == s2 == 200
        kept = np.flatnonzero(ref["valid"][i])
        assert resp["num_cells"] == len(kept)
        cells += len(kept)
        for cell, m, k in zip(resp["cells"], resp["masks"], kept):
            for key in METRIC_KEYS:
                want = float(ref["metrics"][key][i, k])
                if key in INT_METRIC_KEYS:
                    assert cell[key] == int(round(want)), key
                else:
                    assert cell[key] == pytest.approx(want, rel=1e-5, abs=1e-5), key
            assert m["offset"] == ref["offsets"][i, k].tolist()
            np.testing.assert_array_equal(decode_binary_mask(m), ref["mask_crops"][i, k])
        keys, _, boxes, scores, metrics, masks = _parse_bin(buf)
        np.testing.assert_array_equal(boxes, np.asarray(resp["boxes"], np.float32))
        np.testing.assert_array_equal(scores, np.asarray(resp["scores"], np.float32))
        np.testing.assert_array_equal(
            metrics, np.asarray([[c[k] for k in keys] for c in resp["cells"]],
                                np.float32).reshape(metrics.shape))
        for (offset, bits), m in zip(masks, resp["masks"]):
            assert offset == m["offset"]
            np.testing.assert_array_equal(bits, decode_binary_mask(m))
    assert cells > 0


def test_serve_cli_runs_on_the_card_unless_asked(monkeypatch):
    """The CLI takes the JAX CLI's arguments; its pipeline is on the card by
    default, so without one it raises before serving; a bad geometry is an
    argument error."""
    from yolo_sam_inference_tpu_torch.apps import serve as tapp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.main(["--port", "0", "--image-size", "64x64"])
    with pytest.raises(SystemExit):
        tapp.main(["--image-size", "64x64x4", "--device", "cpu"])


# ----------------------------------------------------------------- the bench


@pytest.mark.parametrize("fmt", ["json", "bin"])
def test_serve_bench_on_the_cpu(monkeypatch, fmt):
    """The bench at a tiny cell on the CPU gives one JSON line with the JAX
    bench's keys and the card's; the command refuses to run without a card
    and prints no result."""
    monkeypatch.setitem(tengine.SAM_CONFIGS, "tiny-test", sam_tiny_test)
    monkeypatch.setenv("BENCH_SAM", "tiny-test")
    line = json.dumps(bserve.run(["--batch", "2", "--size", "64", "--inflight", "4",
                                  "--requests", "8", "--warm-requests", "2", "--masks",
                                  "--fmt", fmt], device="cpu"))
    result = json.loads(line)
    assert set(result) == {"metric", "value", "unit", "host_cpu_ms_per_request",
                           "p50_request_latency_ms", "p99_request_latency_ms",
                           "mean_batch_fill", "errors", "warmup_s", "inflight", "card"}
    assert result["errors"] == 0 and result["value"] > 0 and result["inflight"] == 4
    assert 1.0 <= result["mean_batch_fill"] <= 2.0 and fmt in result["metric"]
    assert result["card"] == "cpu (no card)"
    if fmt == "bin" or torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, "-m", "yolo_sam_inference_tpu_torch.bench.serve"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""
