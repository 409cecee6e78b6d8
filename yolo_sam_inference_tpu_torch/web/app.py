"""Browser-based ROI selection on the port.

A copy of the JAX package's ``web/app.py`` (which the port may not import)
but for the image it serves: the condition's frame is encoded as PNG by the
port's writer (``io/png.py``), not by PIL. It runs on the stdlib
``http.server`` and is thread-safe: one ``RoiSession`` guards its state with
a lock, and a ``threading.Event`` signals completion (no polling, no module
globals).

Flow: serve the first usable image of each condition (skipping
``background`` images, preferring ``full_frames`` over ``cropped_roi``),
let the user drag a box per condition, persist ``roi_coordinates.json``
after every confirm; default port 9487.
"""

from __future__ import annotations

import html
import json
import threading
from urllib.parse import quote
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, List, Optional

from ..io.images import list_image_files, load_image
from ..io.png import png_bytes
from ..utils.logger import setup_logger

logger = setup_logger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><title>ROI Selection</title><style>
 body { font-family: sans-serif; margin: 2em; background: #111; color: #eee; }
 #wrap { position: relative; display: inline-block; }
 #img { max-width: 90vw; border: 1px solid #555; cursor: crosshair; }
 #box { position: absolute; border: 2px solid #0f0; pointer-events: none; display: none; }
 button { margin-top: 1em; padding: 0.5em 2em; font-size: 1em; }
 .done { color: #0f0; }
</style></head><body>
<h2>Select ROI — condition: <span id="cond">__COND_HTML__</span>
 (<span id="idx">__IDX__</span>/<span id="total">__TOTAL__</span>)</h2>
<p>Click and drag to draw the region of interest, then confirm.</p>
<div id="wrap"><img id="img" src="/image?condition=__COND_URL__">
<div id="box"></div></div><br>
<button id="confirm" disabled>Confirm ROI</button>
<p id="status"></p>
<script>
const img = document.getElementById('img'), box = document.getElementById('box');
let start = null, roi = null;
function clientToNatural(e) {
  const r = img.getBoundingClientRect();
  const sx = img.naturalWidth / r.width, sy = img.naturalHeight / r.height;
  return {x: Math.round((e.clientX - r.left) * sx), y: Math.round((e.clientY - r.top) * sy),
          px: e.clientX - r.left, py: e.clientY - r.top};
}
img.addEventListener('mousedown', e => { start = clientToNatural(e); e.preventDefault(); });
img.addEventListener('mousemove', e => {
  if (!start) return;
  const cur = clientToNatural(e);
  box.style.display = 'block';
  box.style.left = Math.min(start.px, cur.px) + 'px';
  box.style.top = Math.min(start.py, cur.py) + 'px';
  box.style.width = Math.abs(cur.px - start.px) + 'px';
  box.style.height = Math.abs(cur.py - start.py) + 'px';
});
window.addEventListener('mouseup', e => {
  if (!start) return;
  const cur = clientToNatural(e);
  roi = {x_min: Math.min(start.x, cur.x), x_max: Math.max(start.x, cur.x),
         y_min: Math.min(start.y, cur.y), y_max: Math.max(start.y, cur.y)};
  start = null;
  document.getElementById('confirm').disabled = false;
  document.getElementById('status').textContent = JSON.stringify(roi);
});
document.getElementById('confirm').addEventListener('click', async () => {
  const resp = await fetch('/confirm_roi', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({condition: __COND_JS__, ...roi})});
  const data = await resp.json();
  if (data.next) { window.location = '/?condition=' + encodeURIComponent(data.next); }
  else { document.body.innerHTML = '<h2 class="done">All ROIs confirmed — you can close this tab.</h2>'; }
});
</script></body></html>"""


class RoiSession:
    """State for one ROI-selection run (thread-safe)."""

    def __init__(self, condition_images: Dict[str, Path], output_path: Path):
        self.condition_images = condition_images
        self.order = list(condition_images)
        self.rois: Dict[str, Dict[str, int]] = {}
        self.output_path = output_path
        self.lock = threading.Lock()
        self.done = threading.Event()

    def pending(self) -> List[str]:
        with self.lock:
            return [c for c in self.order if c not in self.rois]

    def confirm(self, condition: str, roi: Dict[str, int]) -> Optional[str]:
        with self.lock:
            self.rois[condition] = roi
            with open(self.output_path, "w") as f:
                json.dump(self.rois, f, indent=2)
            remaining = [c for c in self.order if c not in self.rois]
        if not remaining:
            self.done.set()
            return None
        return remaining[0]


def _make_handler(session: RoiSession):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logger.debug("web: " + fmt, *args)

        def _send(self, code, body: bytes, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            qs = parse_qs(url.query)
            if url.path == "/":
                pend = session.pending()
                if not pend:
                    self._send(200, b"<h2>All ROIs confirmed.</h2>")
                    return
                cond = qs.get("condition", [pend[0]])[0]
                if cond not in session.order:
                    self._send(404, b"unknown condition")
                    return
                idx = len(session.order) - len(pend) + 1
                # Per-context escaping: the condition is user-influenced
                # (query param / directory name), so it must never reach the
                # page as raw HTML or raw JS.
                page = (
                    _PAGE.replace("__COND_HTML__", html.escape(cond))
                    .replace("__COND_URL__", html.escape(quote(cond), quote=True))
                    .replace(
                        "__COND_JS__",
                        # json.dumps leaves '<' intact; escape it so the
                        # string can never close a <script> context.
                        json.dumps(cond).replace("<", "\\u003c").replace(">", "\\u003e"),
                    )
                    .replace("__IDX__", str(idx))
                    .replace("__TOTAL__", str(len(session.order)))
                )
                self._send(200, page.encode())
            elif url.path == "/image":
                cond = qs.get("condition", [None])[0]
                path = session.condition_images.get(cond)
                if path is None:
                    self._send(404, b"unknown condition")
                    return
                # any source format -> PNG for the browser
                self._send(200, png_bytes(load_image(path)), "image/png")
            elif url.path == "/health":
                self._send(200, b"ok", "text/plain")
            else:
                self._send(404, b"not found")

        def do_POST(self):
            if self.path != "/confirm_roi":
                self._send(404, b"not found")
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(length))
                cond = data["condition"]
                roi = {k: int(data[k]) for k in ("x_min", "x_max", "y_min", "y_max")}
            except (json.JSONDecodeError, KeyError, ValueError):
                self._send(400, b'{"error": "bad request"}', "application/json")
                return
            if cond not in session.order:
                self._send(404, b'{"error": "unknown condition"}', "application/json")
                return
            nxt = session.confirm(cond, roi)
            self._send(
                200, json.dumps({"ok": True, "next": nxt}).encode(), "application/json"
            )

    return Handler


def pick_condition_image(condition_dir: Path) -> Optional[Path]:
    """First usable image of a condition: skip ``background`` files, prefer
    ``full_frames`` dirs over ``cropped_roi``."""
    candidates = [
        p
        for p in list_image_files(condition_dir, recursive=True)
        if "background" not in p.name.lower()
    ]
    if not candidates:
        return None
    full = [p for p in candidates if "full_frames" in str(p.parent)]
    return full[0] if full else candidates[0]


def run_server(
    session: RoiSession, port: int = 9487, host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """Bind localhost by default; pass ``host="0.0.0.0"`` explicitly to
    expose the picker to the network (the page renders operator-side)."""
    server = ThreadingHTTPServer((host, port), _make_handler(session))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def get_roi_coordinates_web(
    condition_dirs: List[Path],
    run_output_dir: Path,
    port: int = 9487,
    timeout: Optional[float] = None,
    host: str = "127.0.0.1",
) -> Dict[str, Dict[str, int]]:
    """Serve the picker and block until every condition has an ROI.

    Returns {condition: {x_min, x_max, y_min, y_max}} and writes
    ``roi_coordinates.json`` into ``run_output_dir`` after every confirm.
    """
    condition_images = {}
    for d in condition_dirs:
        img = pick_condition_image(Path(d))
        if img is not None:
            condition_images[Path(d).name] = img
        else:
            logger.warning("No selectable image for condition %s", d)
    if not condition_images:
        return {}

    Path(run_output_dir).mkdir(parents=True, exist_ok=True)
    session = RoiSession(condition_images, Path(run_output_dir) / "roi_coordinates.json")
    server = run_server(session, port, host=host)
    logger.info("ROI selection running at http://localhost:%d/ — waiting...", port)
    try:
        if not session.done.wait(timeout):
            raise TimeoutError("ROI selection did not complete in time")
    finally:
        server.shutdown()
    return session.rois
