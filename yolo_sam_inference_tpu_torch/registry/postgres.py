"""Postgres adapter with the WorkManifest interface.

A copy of the JAX package's ``registry/postgres.py`` (which the port may not
import).

Capability parity with reference ``tools/postgres_data_create.py``:
auto-creates the ``yolo_sam_inference`` database (``:140-186``), purpose
tables from the three templates with a GIN index on results (``:206-224``),
bulk ingest via temp table + COPY + ``ON CONFLICT (minio_path) DO UPDATE``
(``:427-722``), prefix search of a ``minio_tracking.objects`` source table
(``:232-425``), and list/summary commands (``:746-841``).

psycopg2 is not installed in this environment, so everything gates behind a
lazy import; the sqlite :class:`~.manifest.WorkManifest` carries the same
semantics for local runs. Env-var config matches the reference
(``POSTGRES_*`` / ``TARGET_POSTGRES_*`` — ``:54-65``).
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

PG_TABLE_TEMPLATES = {
    "standard": """
        CREATE TABLE IF NOT EXISTS {name} (
            id SERIAL PRIMARY KEY,
            minio_path TEXT UNIQUE NOT NULL,
            empty BOOLEAN DEFAULT FALSE,
            results JSONB,
            error TEXT,
            created_at TIMESTAMPTZ DEFAULT now(),
            updated_at TIMESTAMPTZ DEFAULT now()
        )""",
    "experiment": """
        CREATE TABLE IF NOT EXISTS {name} (
            id SERIAL PRIMARY KEY,
            minio_path TEXT UNIQUE NOT NULL,
            condition_name TEXT,
            batch_name TEXT,
            empty BOOLEAN DEFAULT FALSE,
            results JSONB,
            error TEXT,
            created_at TIMESTAMPTZ DEFAULT now(),
            updated_at TIMESTAMPTZ DEFAULT now()
        )""",
    "time_series": """
        CREATE TABLE IF NOT EXISTS {name} (
            id SERIAL PRIMARY KEY,
            minio_path TEXT UNIQUE NOT NULL,
            frame_index INTEGER,
            timestamp TIMESTAMPTZ,
            empty BOOLEAN DEFAULT FALSE,
            results JSONB,
            error TEXT,
            created_at TIMESTAMPTZ DEFAULT now(),
            updated_at TIMESTAMPTZ DEFAULT now()
        )""",
}

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".tif", ".bmp")


def _connect(dbname: Optional[str] = None):
    try:
        import psycopg2  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "psycopg2 is not installed; use registry.manifest.WorkManifest "
            "(sqlite) for local manifests"
        ) from e
    return psycopg2.connect(
        host=os.environ.get("POSTGRES_HOST", "localhost"),
        port=int(os.environ.get("POSTGRES_PORT", "5432")),
        user=os.environ.get("POSTGRES_USER", "postgres"),
        password=os.environ.get("POSTGRES_PASSWORD", ""),
        dbname=dbname or os.environ.get("POSTGRES_DB", "yolo_sam_inference"),
    )


def ensure_database(dbname: str = "yolo_sam_inference") -> None:
    """Create the target database if missing (reference ``:140-186``)."""
    conn = _connect("postgres")
    conn.autocommit = True
    with conn.cursor() as cur:
        cur.execute("SELECT 1 FROM pg_database WHERE datname = %s", (dbname,))
        if cur.fetchone() is None:
            cur.execute(f'CREATE DATABASE "{dbname}"')
    conn.close()


class PostgresManifest:
    """WorkManifest-compatible adapter over Postgres JSONB tables."""

    def __init__(self, table: str = "images", template: str = "standard",
                 dbname: Optional[str] = None):
        self.table = table
        self.conn = _connect(dbname)
        with self.conn.cursor() as cur:
            cur.execute(PG_TABLE_TEMPLATES[template].format(name=table))
            cur.execute(
                f"CREATE INDEX IF NOT EXISTS idx_{table}_results_gin "
                f"ON {table} USING GIN (results)"
            )
        self.conn.commit()

    def ingest(self, paths: Iterable[str], **extra_cols) -> int:
        """Bulk ingest via temp table + COPY + upsert (reference ``:427-722``)."""
        paths = [str(p) for p in paths]
        with self.conn.cursor() as cur:
            cur.execute(
                f"CREATE TEMP TABLE _staging (minio_path TEXT) ON COMMIT DROP"
            )
            buf = io.StringIO("".join(p + "\n" for p in paths))
            cur.copy_expert("COPY _staging (minio_path) FROM STDIN", buf)
            cur.execute(
                f"INSERT INTO {self.table} (minio_path) "
                f"SELECT minio_path FROM _staging "
                f"ON CONFLICT (minio_path) DO UPDATE SET updated_at = now()"
            )
        self.conn.commit()
        return len(paths)

    def ingest_from_tracking(self, prefix: str, source_table: str = "minio_tracking.objects") -> int:
        """Prefix search of the acquisition tracking table for image objects
        (reference ``find_matching_objects :232-425``)."""
        exts = tuple(f"%{e}" for e in IMAGE_EXTENSIONS)
        with self.conn.cursor() as cur:
            cur.execute(
                f"INSERT INTO {self.table} (minio_path) "
                f"SELECT object_path FROM {source_table} "
                f"WHERE object_path LIKE %s AND (" +
                " OR ".join(["object_path ILIKE %s"] * len(exts)) + ") "
                f"ON CONFLICT (minio_path) DO NOTHING",
                (prefix + "%", *exts),
            )
            n = cur.rowcount
        self.conn.commit()
        return n

    def pending(self, limit: Optional[int] = None) -> List[str]:
        q = (
            f"SELECT minio_path FROM {self.table} "
            f"WHERE results IS NULL AND error IS NULL ORDER BY id"
        )
        if limit:
            q += f" LIMIT {int(limit)}"
        with self.conn.cursor() as cur:
            cur.execute(q)
            return [r[0] for r in cur.fetchall()]

    def record_result(self, path: str, results: Sequence[Dict[str, Any]],
                      empty: bool = False) -> None:
        with self.conn.cursor() as cur:
            cur.execute(
                f"UPDATE {self.table} SET results = %s, empty = %s, error = NULL, "
                f"updated_at = now() WHERE minio_path = %s",
                (json.dumps(list(results)), empty, str(path)),
            )
        self.conn.commit()

    def record_error(self, path: str, error: str) -> None:
        with self.conn.cursor() as cur:
            cur.execute(
                f"UPDATE {self.table} SET error = %s, updated_at = now() "
                f"WHERE minio_path = %s",
                (str(error)[:2000], str(path)),
            )
        self.conn.commit()

    def get_results(self, path: str) -> Optional[List[Dict[str, Any]]]:
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT results FROM {self.table} WHERE minio_path = %s",
                (str(path),),
            )
            row = cur.fetchone()
        if row is None or row[0] is None:
            return None
        # psycopg2 decodes jsonb to python; raw strings still parse
        return row[0] if isinstance(row[0], list) else json.loads(row[0])

    def list_rows(self, limit: int = 20) -> List[Dict[str, Any]]:
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT minio_path, empty, results IS NOT NULL, error "
                f"FROM {self.table} ORDER BY id LIMIT %s",
                (int(limit),),
            )
            return [
                {"minio_path": p, "empty": bool(e), "has_results": bool(h),
                 "error": err}
                for p, e, h, err in cur.fetchall()
            ]

    def list_tables(self) -> List[str]:
        """Result tables in the public schema (the reference viewer's table
        picker, ``tools/postgres_result_viewer.py:251-366``)."""
        with self.conn.cursor() as cur:
            cur.execute(
                "SELECT table_name FROM information_schema.tables "
                "WHERE table_schema = 'public' ORDER BY table_name"
            )
            return [r[0] for r in cur.fetchall()]

    def close(self) -> None:
        self.conn.close()

    def summary(self) -> Dict[str, Any]:
        with self.conn.cursor() as cur:
            cur.execute(
                f"SELECT COUNT(*), COUNT(results), "
                f"COUNT(error), COUNT(*) FILTER (WHERE empty) FROM {self.table}"
            )
            total, done, errors, empty = cur.fetchone()
            # Count rows where at least one result object carries a
            # 'deformability' key (jsonb ? tests key existence; the
            # doubled ?? escapes the psycopg2 placeholder).
            cur.execute(
                f"SELECT COUNT(*) FROM {self.table} "
                f"WHERE results IS NOT NULL AND EXISTS ("
                f"  SELECT 1 FROM jsonb_array_elements(results) elem"
                f"  WHERE elem ?? 'deformability')"
            )
            with_deform = cur.fetchone()[0]
        return {
            "table": self.table,
            "total": total,
            "completed": done,
            "errors": errors,
            "empty": empty,
            "with_deformability": with_deform,
            "percent_complete": 100.0 * done / total if total else 0.0,
        }
