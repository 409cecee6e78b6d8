"""Result viewer for manifest-stored results — static report or live server.

The JAX package's ``apps/result_viewer.py`` on the port, with two changes:

* the row image is drawn in numpy (the green mask overlay, the red box
  outlines) and written by the port's PNG writer (``io/png.py``), not PIL;
  the confidence and deformability labels PIL wrote above each box stand in
  the row's table instead;
* every value written into a page is HTML-escaped (the manifest path, the
  table names, error texts and each cell value), and the links' paths are
  quoted with ``urllib.parse.quote``: the JAX viewer writes them raw, so a
  path or a value holding markup runs in the browser.

Replaces the reference's Streamlit+MinIO viewer
(reference ``tools/postgres_result_viewer.py``): renders stored rows — boxes,
decoded masks as green overlays, and a metrics table. Masks decode via the
shared codec (``utils/mask_encoding``, the consumer contract at reference
``:101-108``).

Two modes:

* default — one self-contained static HTML report (``--output``).
* ``--serve PORT`` — a live stdlib-HTTP browser matching the reference
  viewer's DB-backed flow (``postgres_result_viewer.py:251-366``): a
  table picker at ``/``, paginated row lists at ``/t/<table>``, and
  per-row on-demand image fetch + render at ``/t/<table>/row?path=...``
  (images are fetched and drawn only when a row is opened, like the
  reference's MinIO on-demand fetch).

Backends: the sqlite manifest (``--manifest``) or Postgres
(``--postgres`` [+ ``--dbname``], import-gated like every DB adapter —
reference ``:427-722``); both expose the same row/results API.
"""

from __future__ import annotations

import argparse
import base64
from html import escape
from pathlib import Path
from typing import Any, Dict, List
from urllib.parse import quote

import numpy as np

from ..io.png import png_bytes
from ..registry.manifest import WorkManifest
from ..utils.logger import setup_logger
from ..utils.mask_encoding import decode_binary_mask

logger = setup_logger(__name__)

COLUMNS = ("deformability", "area", "circularity", "ch_area", "mean_brightness", "confidence")
HEADER = ("<table border=1 cellpadding=4><tr><th>deformability</th><th>area</th>\n"
          "<th>circularity</th><th>ch_area</th><th>brightness</th><th>conf</th></tr>\n")


def _draw_box(img: np.ndarray, box: Dict[str, float], colour) -> None:
    """A one-pixel rectangle outline with corners (x_min, y_min) and (x_max,
    y_max) included, clipped to the image (PIL ``ImageDraw.rectangle`` with
    ``outline=`` and integer corners)."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (int(box[k]) for k in ("x_min", "y_min", "x_max", "y_max"))
    if x1 < x0 or y1 < y0:
        return
    cx0, cx1 = max(x0, 0), min(x1, w - 1)
    cy0, cy1 = max(y0, 0), min(y1, h - 1)
    if cx0 > cx1 or cy0 > cy1:
        return
    for y in (y0, y1):
        if 0 <= y < h:
            img[y, cx0:cx1 + 1] = colour
    for x in (x0, x1):
        if 0 <= x < w:
            img[cy0:cy1 + 1, x] = colour


def render_row_image(image: np.ndarray, results: List[Dict[str, Any]]) -> str:
    """Draw the green mask overlay and the boxes; return a base64 PNG."""
    overlay = image.astype(np.float32)
    for r in results:
        if "mask" in r and r["mask"]:
            try:
                mask = decode_binary_mask(r["mask"])
                if mask.shape == image.shape[:2]:
                    overlay[mask] = overlay[mask] * 0.5 + np.asarray([0, 255, 0]) * 0.5
            except (ValueError, KeyError):
                pass
    img = overlay.astype(np.uint8)
    for r in results:
        if r.get("box"):
            _draw_box(img, r["box"], (255, 0, 0))
    return base64.b64encode(png_bytes(img)).decode("ascii")


def _cells(results: List[Dict[str, Any]]) -> str:
    """The metrics table's rows, each value escaped."""
    return "".join(
        "<tr>" + "".join(
            f"<td>{escape(str(r.get(k, '')) if not isinstance(r.get(k), dict) else '...')}</td>"
            for k in COLUMNS
        ) + "</tr>"
        for r in results
    )


def _image_html(path: str, results, fetcher, max_width: int) -> str:
    try:
        b64 = render_row_image(fetcher(path), results)
        return f'<img src="data:image/png;base64,{b64}" style="max-width:{max_width}px">'
    except (OSError, ValueError) as e:
        return f"<em>image unavailable: {escape(str(e))}</em>"


def build_report(
    manifest: WorkManifest,
    output_path: Path,
    max_rows: int = 20,
    fetcher=None,
) -> Path:
    """Render up to ``max_rows`` completed manifest rows into an HTML report."""
    if fetcher is None:
        fetcher = _fs_fetch

    rows = [r for r in manifest.list_rows(limit=10000) if r["has_results"]][:max_rows]
    sections = []
    for row in rows:
        results = manifest.get_results(row["minio_path"]) or []
        img_html = _image_html(row["minio_path"], results, fetcher, 600)
        sections.append(f"""
<section><h3>{escape(row['minio_path'])}</h3>{img_html}
{HEADER}{_cells(results)}</table></section>""")
    summary = manifest.summary()
    table = escape(str(summary["table"]))
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Results: {table}</title>
<style>body{{font-family:sans-serif;margin:2em}} section{{margin-bottom:2em}}</style>
</head><body><h1>Result viewer — {table}</h1>
<p>{summary['completed']}/{summary['total']} complete
({summary['percent_complete']:.1f}%), {summary['errors']} errors,
{summary['empty']} empty.</p>
{''.join(sections)}</body></html>"""
    output_path = Path(output_path)
    output_path.write_text(html, encoding="utf-8")
    logger.info("wrote %s (%d rows)", output_path, len(rows))
    return output_path


def _fs_fetch(path: str) -> np.ndarray:
    from ..io.images import load_image

    return load_image(path)


def _row_page(manifest, table: str, path: str, fetcher) -> str:
    results = manifest.get_results(path) or []
    img_html = _image_html(path, results, fetcher, 700)
    t, p = escape(table), escape(path)
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8"><title>{p}</title>
<style>body{{font-family:sans-serif;margin:2em}}</style></head><body>
<p><a href="/t/{quote(table, safe='')}">&larr; {t}</a></p><h2>{p}</h2>{img_html}
{HEADER}{_cells(results)}</table></body></html>"""


def _table_page(manifest, table: str, limit: int) -> str:
    s = manifest.summary()
    link = quote(table, safe="")
    items = "".join(
        f'<li><a href="/t/{link}/row?path={quote(r["minio_path"], safe="")}">'
        f'{escape(r["minio_path"])}</a>'
        f'{" — error: " + escape(str(r["error"])) if r["error"] else ""}'
        f'{"" if r["has_results"] else " (pending)"}</li>'
        for r in manifest.list_rows(limit=limit)
    )
    t = escape(table)
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{t}</title><style>body{{font-family:sans-serif;margin:2em}}</style>
</head><body><p><a href="/">&larr; tables</a></p><h1>{t}</h1>
<p>{s['completed']}/{s['total']} complete ({s['percent_complete']:.1f}%),
{s['errors']} errors, {s['empty']} empty.</p><ul>{items}</ul></body></html>"""


def serve_viewer(make_manifest, tables, host: str, port: int,
                 fetcher=None, max_rows: int = 200):
    """Live result browser (reference viewer's flow: table picker ->
    row list -> on-demand image render). ``make_manifest(table)`` builds a
    manifest adapter; ``tables`` lists selectable tables. Returns the
    configured HTTPServer (caller owns serve_forever — tests drive it in
    a thread)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, unquote, urlparse

    if fetcher is None:
        fetcher = _fs_fetch

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            pass

        def _html(self, code, body):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            u = urlparse(self.path)
            try:
                if u.path in ("", "/"):
                    links = "".join(
                        f'<li><a href="/t/{quote(t, safe="")}">{escape(t)}</a></li>'
                        for t in tables
                    )
                    return self._html(200, (
                        '<!DOCTYPE html><html><head><meta charset="utf-8">'
                        "<title>Result tables</title></head><body>"
                        f"<h1>Result tables</h1><ul>{links}</ul></body></html>"
                    ))
                parts = [unquote(s) for s in u.path.split("/") if s]
                if len(parts) >= 2 and parts[0] == "t" and parts[1] in tables:
                    table = parts[1]
                    m = make_manifest(table)
                    try:
                        if len(parts) == 2:
                            return self._html(
                                200, _table_page(m, table, max_rows))
                        if len(parts) == 3 and parts[2] == "row":
                            path = parse_qs(u.query).get("path", [""])[0]
                            return self._html(
                                200, _row_page(m, table, path, fetcher))
                    finally:
                        close = getattr(m, "close", None)
                        if close:
                            close()
                return self._html(404, "<h1>not found</h1>")
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("viewer request failed")
                return self._html(500, f"<h1>error</h1><pre>{escape(str(e))}</pre>")

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Render stored results to HTML (static or --serve)")
    p.add_argument("--manifest", type=Path, default=None,
                   help="sqlite manifest path")
    p.add_argument("--postgres", action="store_true",
                   help="read from Postgres (PG* env / --dbname) instead of "
                        "the sqlite manifest — the reference viewer's "
                        "DB-backed flow")
    p.add_argument("--dbname", type=str, default=None)
    p.add_argument("--table", type=str, default="images")
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--max-rows", type=int, default=20)
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="live browser: table picker + on-demand row render")
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(argv)

    if args.postgres:
        from ..registry.postgres import PostgresManifest

        def make_manifest(table):
            return PostgresManifest(table=table, dbname=args.dbname)
    elif args.manifest is not None:
        def make_manifest(table):
            return WorkManifest(args.manifest, table=table)
    else:
        p.error("one of --manifest or --postgres is required")

    if args.serve is not None:
        m = make_manifest(args.table)
        tables = (m.list_tables() if hasattr(m, "list_tables")
                  else [args.table])
        close = getattr(m, "close", None)
        if close:
            close()
        server = serve_viewer(make_manifest, tables, args.host, args.serve)
        print(f"result viewer on {args.host}:{server.server_address[1]}")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    if args.output is None:
        p.error("--output is required without --serve")
    build_report(make_manifest(args.table), args.output, args.max_rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
