"""Micro-batching inference service: HTTP in, per-cell metrics JSON out.

The port of the JAX package's ``web/serve.py``, with the same endpoints,
status codes, response layouts and batching. Requests queue on the host, and
a SINGLE collector thread owns the pipeline and its card: it drains the
queue into batches of ``batch_size`` frames, zero-padded to that size (one
shape, so a request's rows never depend on how many other requests shared
its batch), dispatches each through the pipeline's ``_dispatch_batch`` and
``_fetch_outputs``, and hands every request its batch's host arrays. Request
threads format their own responses.

Endpoints:

* ``POST /segment`` — request body is a PNG/TIFF image (JPEG and the other
  forms PIL reads, where PIL is installed), or raw ``(H, W)`` uint8 with
  ``X-Shape: HxW`` and content-type ``application/octet-stream``. Optional
  query ``?masks=1`` adds wire-codec masks (``utils/mask_encoding``,
  reference-compatible). Response: ``{"num_cells", "boxes", "scores",
  "cells": [{metric: value, ...}], ["masks"]}``.

  With ``?fmt=bin`` (or ``Accept: application/octet-stream``) the
  response is the packed binary record below instead of JSON, byte for
  byte the JAX service's:

  .. code-block:: text

      magic   b"YSB1"
      u32     num_cells
      u32     n_metrics
      u32     flags            bit0: masks section present
      u32     keys_len; keys   comma-joined metric names (utf-8)
      f32[num_cells, 4]        boxes (x0, y0, x1, y1)
      f32[num_cells]           scores
      f32[num_cells, n_metrics] metric rows (int-metrics pre-rounded)
      masks (if flags&1), per cell:
          u32 off_y; u32 off_x; u32 h; u32 w; u32 nbytes
          nbytes of zlib(packbits(mask))   # same wire codec as JSON mode

  All integers little-endian.
* ``GET /healthz`` — liveness (200 once a batch has run on the card).
* ``GET /stats`` — requests served, batches dispatched, mean batch fill.

Decoding needs no PIL: PNG through the native
decoder (``io/png_native.py``; mode L stays (H, W)), the gray + alpha and
RGBA forms with their alpha plane (``io/png.py``), TIFF through
``io/tiff.py``; PIL, where it is installed, takes the other forms. A body
none of them reads is a 400 with the reason. Color inputs: replicated-RGB
collapses to grayscale exactly like the directory loader; true-color RGB
passes through unchanged but must match the service's geometry — a color
frame sent to a grayscale service gets a 400, never a silent collapse.
Opaque RGBA drops its alpha plane; non-opaque RGBA is a 400.

Batching knobs: ``batch_size`` (the dispatched batch — requests pad up to
it), ``max_wait_ms`` (how long the collector waits to fill a batch before
dispatching a partial one). All images in one service share one shape: the
first request's (H, W) fixes it (or ``image_shape=``); mismatched inputs get
400 — production deployments run one service per camera geometry.
"""

from __future__ import annotations

import io
import json
import queue
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io import images as _images
from ..io.png import PNG_SIGNATURE, decode_png_alpha, has_alpha_form
from ..io.png_native import decode_png
from ..io.tiff import decode_tiff
from ..ops.metrics import INT_METRIC_KEYS, METRIC_KEYS
from ..utils.logger import setup_logger

logger = setup_logger(__name__)

# request-body cap: a 2048x2048 RGB raw frame is ~12.6 MB; anything past
# 32 MB is not a microscopy frame and should not allocate
MAX_BODY_BYTES = 32 * 1024 * 1024
_TIFF_MAGIC = (b"II*\x00", b"MM\x00*")


class _Pending:
    __slots__ = ("image", "want_masks", "event", "out", "index", "error",
                 "abandoned")

    def __init__(self, image: np.ndarray, want_masks: bool):
        self.image = image
        self.want_masks = want_masks
        self.event = threading.Event()
        # the collector stores the batch outputs + this request's row; the
        # REQUEST thread formats its own response (JSON or binary), so
        # serialization cost parallelizes across connection threads instead
        # of serializing on the device-owner thread
        self.out: Optional[Dict[str, np.ndarray]] = None
        self.index = -1
        self.error: Optional[str] = None
        # set by the client side on timeout: the collector drops abandoned
        # entries instead of burning device batches nobody will read
        self.abandoned = False


class InferenceService:
    """Owns the pipeline + the collector thread; serves via stdlib HTTP.

    Only the collector thread touches the pipeline once :meth:`start` has
    run (its host slots are not thread-safe): :meth:`warmup` runs before it.
    """

    def __init__(
        self,
        pipeline,
        batch_size: Optional[int] = None,
        max_wait_ms: float = 5.0,
        image_shape: Optional[Tuple[int, ...]] = None,
        request_timeout_s: float = 60.0,
    ):
        self.pipeline = pipeline
        self.batch_size = int(batch_size or pipeline.options.batch_size)
        self.max_wait_s = max_wait_ms / 1e3
        self.image_shape = tuple(image_shape) if image_shape else None
        self.request_timeout_s = request_timeout_s
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._warm = threading.Event()
        self._lock = threading.Lock()  # stats + lazy image_shape init
        self.stats = {"requests": 0, "batches": 0, "images_batched": 0,
                      "errors": 0, "abandoned": 0}
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)

    # -- device-owner side -----------------------------------------------------

    def start(self) -> None:
        self._collector.start()

    def stop(self) -> None:
        self._stop.set()
        self._collector.join(timeout=5)

    def warmup(self) -> None:
        """Run the pipeline once on zeros (so /healthz means 'ready', not
        'will build its stages on your first request'). Call it before
        :meth:`start`."""
        if self.image_shape is None:
            return
        if self._collector.is_alive():
            raise RuntimeError("warmup() runs before start(): the collector owns the pipeline")
        zeros = np.zeros((self.batch_size, *self.image_shape), np.uint8)
        self.pipeline._fetch_outputs(self.pipeline._dispatch_batch(zeros, fetch_masks=True))
        self._warm.set()

    def _collect_loop(self) -> None:
        device = getattr(self.pipeline, "device", None)
        if device is not None and device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)  # per thread: a service on cuda:1 stays there
        with torch.inference_mode():  # per thread, like the device
            while not self._stop.is_set():
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.monotonic() + self.max_wait_s
                while len(batch) < self.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._q.get(timeout=remaining))
                    except queue.Empty:
                        break
                live = [p for p in batch if not p.abandoned]
                with self._lock:
                    self.stats["abandoned"] += len(batch) - len(live)
                if live:
                    self._run_batch(live)

    def _run_batch(self, batch: List[_Pending]) -> None:
        try:
            n = len(batch)
            imgs = np.zeros((self.batch_size, *batch[0].image.shape), np.uint8)
            for i, p in enumerate(batch):
                imgs[i] = p.image
            want_masks = any(p.want_masks for p in batch)
            # the arrays _fetch_outputs returns are this batch's own: a request
            # thread may read them after the next batch has reused the slot
            out = self.pipeline._fetch_outputs(
                self.pipeline._dispatch_batch(imgs, fetch_masks=want_masks)
            )
            self._warm.set()
            with self._lock:
                self.stats["batches"] += 1
                self.stats["images_batched"] += n
            for i, p in enumerate(batch):
                if p.abandoned:  # timed out after dequeue: nobody reads it
                    continue
                p.out, p.index = out, i
                p.event.set()
        except Exception as e:  # the collector must outlive one failed batch
            logger.exception("batch failed")
            with self._lock:
                self.stats["errors"] += 1
            for p in batch:
                p.error = str(e)
                p.event.set()

    @staticmethod
    def _format_response(out: Dict[str, np.ndarray], i: int,
                         want_masks: bool) -> Dict[str, Any]:
        valid = np.asarray(out["valid"][i], bool)
        kidx = np.flatnonzero(valid)
        # same int-metric rounding as every CSV surface
        # (engine._results_from_outputs) so serving and batch outputs agree
        cells = [
            {k: (int(round(float(out["metrics"][k][i, j])))
                 if k in INT_METRIC_KEYS else float(out["metrics"][k][i, j]))
             for k in METRIC_KEYS}
            for j in kidx
        ]
        resp: Dict[str, Any] = {
            "num_cells": int(kidx.size),
            "boxes": np.asarray(out["boxes"][i][kidx], float).tolist(),
            "scores": np.asarray(out["scores"][i][kidx], float).tolist(),
            "cells": cells,
        }
        if want_masks and out.get("mask_crops") is not None:
            from ..utils.mask_encoding import encode_binary_mask

            offs = np.asarray(out["offsets"][i][kidx], int).tolist()
            resp["masks"] = [
                {"offset": offs[jj],
                 **encode_binary_mask(np.asarray(out["mask_crops"][i][j]))}
                for jj, j in enumerate(kidx)
            ]
        return resp

    @staticmethod
    def _format_response_bin(out: Dict[str, np.ndarray], i: int,
                             want_masks: bool) -> bytes:
        """Packed little-endian record (layout in the module docstring):
        one ndarray.tobytes() per section instead of per-value JSON floats."""
        valid = np.asarray(out["valid"][i], bool)
        kidx = np.flatnonzero(valid)
        keys = ",".join(METRIC_KEYS).encode()
        metrics = np.stack(
            [np.asarray(out["metrics"][k][i][kidx], np.float32)
             for k in METRIC_KEYS],
            axis=1,
        ) if kidx.size else np.zeros((0, len(METRIC_KEYS)), np.float32)
        for col, k in enumerate(METRIC_KEYS):  # CSV-surface int rounding
            if k in INT_METRIC_KEYS:
                metrics[:, col] = np.round(metrics[:, col])
        has_masks = want_masks and out.get("mask_crops") is not None
        parts = [
            b"YSB1",
            struct.pack("<III", kidx.size, len(METRIC_KEYS), int(has_masks)),
            struct.pack("<I", len(keys)), keys,
            np.asarray(out["boxes"][i][kidx], np.float32).tobytes(),
            np.asarray(out["scores"][i][kidx], np.float32).tobytes(),
            metrics.tobytes(),
        ]
        if has_masks:
            offs = np.asarray(out["offsets"][i][kidx], int)
            for jj, j in enumerate(kidx):
                m = np.asarray(out["mask_crops"][i][j])
                blob = zlib.compress(np.packbits(m.astype(np.uint8)).tobytes())
                parts.append(struct.pack(
                    "<IIIII", int(offs[jj][0]), int(offs[jj][1]),
                    m.shape[0], m.shape[1], len(blob)))
                parts.append(blob)
        return b"".join(parts)

    # -- request side ----------------------------------------------------------

    @staticmethod
    def _normalize_channels(image: np.ndarray) -> np.ndarray:
        """Loader-parity channel policy (serving must not silently diverge
        from the directory path). Replicated-RGB collapses to one plane; true
        color stays (H, W, 3); opaque RGBA drops alpha; translucent RGBA is
        rejected."""
        if image.ndim != 3:
            return image
        if image.shape[-1] == 4:
            if not (image[..., 3] == 255).all():
                raise ValueError(
                    "RGBA with non-opaque alpha is not supported; "
                    "flatten client-side"
                )
            image = image[..., :3]
        if image.ndim == 3 and image.shape[-1] == 3 and np.array_equal(
            image[..., 0], image[..., 1]
        ) and np.array_equal(image[..., 1], image[..., 2]):
            return image[..., 0]
        return image

    def submit(self, image: np.ndarray, want_masks: bool,
               timeout: Optional[float] = None, fmt: str = "json"):
        image = self._normalize_channels(image)
        with self._lock:  # lazy shape init must be single-winner
            if self.image_shape is None:
                self.image_shape = image.shape
            shape = self.image_shape
            self.stats["requests"] += 1
        if image.shape != tuple(shape):
            raise ValueError(
                f"image shape {image.shape} != service shape "
                f"{tuple(shape)} (one geometry per service; "
                "color vs grayscale counts)"
            )
        p = _Pending(image, want_masks)
        self._q.put(p)
        if not p.event.wait(timeout or self.request_timeout_s):
            p.abandoned = True  # collector drops it instead of serving it
            raise TimeoutError("inference timed out")
        if p.error:
            raise RuntimeError(p.error)
        if fmt == "bin":
            return self._format_response_bin(p.out, p.index, p.want_masks)
        return self._format_response(p.out, p.index, p.want_masks)


def _decode_image(body: bytes, headers) -> np.ndarray:
    """A request body as the array ``np.asarray(PIL.Image.open(...))`` gives
    (the JAX service's decode), PIL needed only for the forms the port's own
    decoders do not read. Raises ValueError (a 400) for a body no decoder
    takes."""
    ctype = headers.get("Content-Type", "")
    if ctype == "application/octet-stream":
        shape = headers.get("X-Shape", "")
        h, w = (int(v) for v in shape.lower().split("x"))
        arr = np.frombuffer(body, np.uint8)
        if arr.size != h * w:
            raise ValueError(f"raw body size {arr.size} != {h}x{w}")
        return arr.reshape(h, w).copy()
    if body.startswith(PNG_SIGNATURE):
        arr = decode_png_alpha(body) if has_alpha_form(body) else decode_png(body)
        if arr is not None:
            return arr
    elif body[:4] in _TIFF_MAGIC:
        try:
            return decode_tiff(body)
        except (ValueError, KeyError, IndexError, struct.error, zlib.error):
            pass  # a TIFF form the codec does not read: PIL's, where installed
    pil = _images._PILImage
    if pil is None:
        raise ValueError("body is not a form the port decodes without PIL (8-bit PNG "
                         "not interlaced, or the TIFFs io/tiff.py reads), and PIL is not "
                         "installed")
    return np.asarray(pil.open(io.BytesIO(body)))


def _make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                ready = service._warm.is_set()
                self._send(200 if ready else 503,
                           {"status": "ok" if ready else "warming"})
            elif self.path == "/stats":
                with service._lock:
                    s = dict(service.stats)
                s["mean_batch_fill"] = round(
                    s["images_batched"] / s["batches"], 3
                ) if s["batches"] else 0.0
                self._send(200, s)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if not self.path.startswith("/segment"):
                return self._send(404, {"error": "not found"})
            want_masks = "masks=1" in self.path
            fmt = "bin" if (
                "fmt=bin" in self.path
                or "application/octet-stream" in self.headers.get("Accept", "")
            ) else "json"
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY_BYTES:  # bound allocations
                    return self._send(413, {
                        "error": f"body {length} B > cap {MAX_BODY_BYTES} B"})
                img = _decode_image(self.rfile.read(length), self.headers)
                resp = service.submit(np.asarray(img, np.uint8), want_masks, fmt=fmt)
                if fmt == "bin":
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(resp)))
                    self.end_headers()
                    self.wfile.write(resp)
                else:
                    self._send(200, resp)
            except TimeoutError as e:  # an OSError: caught before the 400s
                self._send(504, {"error": str(e)})
            except (ValueError, OSError) as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # the server answers every request
                self._send(500, {"error": str(e)})

    return Handler


class _Server(ThreadingHTTPServer):
    # enough TCP backlog for a full batch of concurrent clients (the
    # stdlib default of 5 refuses connections under load) and daemonic
    # handler threads so shutdown never hangs on a stuck client
    request_queue_size = 256
    daemon_threads = True


def serve(pipeline, host: str = "127.0.0.1", port: int = 9488,
          batch_size: Optional[int] = None, max_wait_ms: float = 5.0,
          image_shape: Optional[Tuple[int, ...]] = None,
          warmup: bool = True):
    """Build + start the service; returns (server, service). Callers own
    ``server.serve_forever()`` (the CLI does; tests drive it in a thread)."""
    service = InferenceService(pipeline, batch_size=batch_size,
                               max_wait_ms=max_wait_ms,
                               image_shape=image_shape)
    if warmup and image_shape is not None:
        service.warmup()  # before the collector starts: it then owns the pipeline
    service.start()
    server = _Server((host, port), _make_handler(service))
    return server, service
