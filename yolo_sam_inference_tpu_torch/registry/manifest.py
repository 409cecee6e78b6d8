"""Work manifest with resume semantics (sqlite3, stdlib).

A copy of the JAX package's ``registry/manifest.py`` (which the port may not
import): the same table templates, SQL and result rows, so a manifest file
written by either package reads back identically through the other.

Schema parity with the reference's Postgres purpose tables
(reference ``tools/postgres_data_create.py:68-117``): three templates
(``standard``/``experiment``/``time_series``), each with a UNIQUE image path,
``empty`` flag, ``results`` JSON, and ``error`` text. Ingestion is
upsert-based (``ON CONFLICT DO UPDATE`` — reference ``:508-525``), so re-runs
only process images whose ``results`` are still NULL
(reference ``pipelines/inference/nodes.py:23-29``).

The stored result rows carry the reference's JSONB result schema
(``tools/postgres_data_create.py:17-33``): encoded ``mask``, ``deformability``,
``area``, ``area_r``, ``circularity``, ``ch_area``, ``mean_brightness``,
``brightness_std``, ``perimeter``, ``ch_perimeter`` (+ ``box`` and
``confidence``, consumed by the result viewer,
``tools/postgres_result_viewer.py:123-144``).
"""

from __future__ import annotations

import json
import sqlite3
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

TABLE_TEMPLATES: Dict[str, str] = {
    "standard": """
        CREATE TABLE IF NOT EXISTS {name} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            minio_path TEXT UNIQUE NOT NULL,
            empty INTEGER DEFAULT 0,
            results TEXT,
            error TEXT,
            created_at REAL,
            updated_at REAL
        )""",
    "experiment": """
        CREATE TABLE IF NOT EXISTS {name} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            minio_path TEXT UNIQUE NOT NULL,
            condition_name TEXT,
            batch_name TEXT,
            empty INTEGER DEFAULT 0,
            results TEXT,
            error TEXT,
            created_at REAL,
            updated_at REAL
        )""",
    "time_series": """
        CREATE TABLE IF NOT EXISTS {name} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            minio_path TEXT UNIQUE NOT NULL,
            frame_index INTEGER,
            timestamp REAL,
            empty INTEGER DEFAULT 0,
            results TEXT,
            error TEXT,
            created_at REAL,
            updated_at REAL
        )""",
}

RESULT_SCHEMA_KEYS = (
    "mask", "deformability", "area", "area_r", "circularity", "ch_area",
    "mean_brightness", "brightness_std", "perimeter", "ch_perimeter",
)


def metrics_to_result_row(metrics: Dict[str, Any], mask_encoded=None,
                          box=None, confidence=None) -> Dict[str, Any]:
    """Map our 16-key metric dict onto the DB-facing result schema."""
    row = {
        "deformability": metrics.get("deformability"),
        "area": metrics.get("area"),
        "area_r": metrics.get("area_ratio"),
        "circularity": metrics.get("circularity"),
        "ch_area": metrics.get("convex_hull_area"),
        "mean_brightness": metrics.get("mean_brightness"),
        "brightness_std": metrics.get("brightness_std"),
        "perimeter": metrics.get("perimeter"),
        "ch_perimeter": metrics.get("convex_hull_perimeter"),
    }
    if mask_encoded is not None:
        row["mask"] = mask_encoded
    if box is not None:
        row["box"] = {
            "x_min": float(box[0]), "y_min": float(box[1]),
            "x_max": float(box[2]), "y_max": float(box[3]),
        }
    if confidence is not None:
        row["confidence"] = float(confidence)
    return row


class WorkManifest:
    """Idempotent per-image work tracking with resume."""

    def __init__(self, db_path, table: str = "images", template: str = "standard"):
        if template not in TABLE_TEMPLATES:
            raise ValueError(f"unknown template {template!r}")
        self.db_path = str(db_path)
        self.table = table
        self._conn = sqlite3.connect(self.db_path)
        self._conn.execute(TABLE_TEMPLATES[template].format(name=table))
        self._conn.execute(
            f"CREATE INDEX IF NOT EXISTS idx_{table}_results ON {table} (results)"
        )
        self._conn.commit()

    # -- ingestion -----------------------------------------------------------

    def ingest(self, paths: Iterable[str], **extra_cols) -> int:
        """Upsert image paths; existing rows keep their results
        (reference COPY+upsert, ``tools/postgres_data_create.py:504-525``)."""
        now = time.time()
        cols = ["minio_path", "created_at", "updated_at"] + list(extra_cols)
        n = 0
        for p in paths:
            values = [str(p), now, now] + [extra_cols[k] for k in extra_cols]
            placeholders = ",".join("?" * len(values))
            self._conn.execute(
                f"INSERT INTO {self.table} ({','.join(cols)}) VALUES ({placeholders}) "
                f"ON CONFLICT (minio_path) DO UPDATE SET updated_at = excluded.updated_at",
                values,
            )
            n += 1
        self._conn.commit()
        return n

    # -- resume --------------------------------------------------------------

    def pending(self, limit: Optional[int] = None) -> List[str]:
        """Paths whose results are still NULL and no error recorded."""
        q = (
            f"SELECT minio_path FROM {self.table} "
            f"WHERE results IS NULL AND error IS NULL ORDER BY id"
        )
        if limit:
            q += f" LIMIT {int(limit)}"
        return [r[0] for r in self._conn.execute(q)]

    def record_result(self, path: str, results: Sequence[Dict[str, Any]],
                      empty: bool = False) -> None:
        self._conn.execute(
            f"UPDATE {self.table} SET results = ?, empty = ?, error = NULL, "
            f"updated_at = ? WHERE minio_path = ?",
            (json.dumps(list(results)), int(empty), time.time(), str(path)),
        )
        self._conn.commit()

    def record_error(self, path: str, error: str) -> None:
        self._conn.execute(
            f"UPDATE {self.table} SET error = ?, updated_at = ? WHERE minio_path = ?",
            (str(error)[:2000], time.time(), str(path)),
        )
        self._conn.commit()

    def get_results(self, path: str) -> Optional[List[Dict[str, Any]]]:
        row = self._conn.execute(
            f"SELECT results FROM {self.table} WHERE minio_path = ?", (str(path),)
        ).fetchone()
        if row is None or row[0] is None:
            return None
        return json.loads(row[0])

    # -- reporting -------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Completion stats (reference ``get_table_summary :746-841``)."""
        total = self._conn.execute(f"SELECT COUNT(*) FROM {self.table}").fetchone()[0]
        done = self._conn.execute(
            f"SELECT COUNT(*) FROM {self.table} WHERE results IS NOT NULL"
        ).fetchone()[0]
        errors = self._conn.execute(
            f"SELECT COUNT(*) FROM {self.table} WHERE error IS NOT NULL"
        ).fetchone()[0]
        empty = self._conn.execute(
            f"SELECT COUNT(*) FROM {self.table} WHERE empty = 1"
        ).fetchone()[0]
        with_masks = 0
        with_deform = 0
        for (res,) in self._conn.execute(
            f"SELECT results FROM {self.table} WHERE results IS NOT NULL"
        ):
            rows = json.loads(res)
            if any("mask" in r for r in rows):
                with_masks += 1
            if any("deformability" in r for r in rows):
                with_deform += 1
        return {
            "table": self.table,
            "total": total,
            "completed": done,
            "errors": errors,
            "empty": empty,
            "with_masks": with_masks,
            "with_deformability": with_deform,
            "percent_complete": 100.0 * done / total if total else 0.0,
        }

    def list_rows(self, limit: int = 20) -> List[Dict[str, Any]]:
        cur = self._conn.execute(
            f"SELECT minio_path, empty, results IS NOT NULL, error FROM {self.table} "
            f"ORDER BY id LIMIT ?",
            (limit,),
        )
        return [
            {"minio_path": p, "empty": bool(e), "has_results": bool(h), "error": err}
            for p, e, h, err in cur
        ]

    def list_tables(self) -> List[str]:
        """Result tables in this sqlite file (the viewer's table picker)."""
        cur = self._conn.execute(
            "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name"
        )
        return [r[0] for r in cur.fetchall()]

    def close(self) -> None:
        self._conn.close()
