"""Batch CSV readout: concatenate per-batch tables into one combined CSV.

A copy of the JAX package's ``registry/readout.py`` (which the port may not
import), without pandas: each file is typed as ``pandas.read_csv`` types it
(``reporting.parse_csv_rows``), the tables are joined as ``pandas.concat``
joins them (``reporting.concat_tables``: columns in order of first appearance, ``batch`` after each
file's own, or in place of its own; an int column missing from a file or
float in one becomes float) and written as ``to_csv(index=False)`` writes
the frame (``reporting.rows_csv_text``). The combined rows come back as a list of
dicts, a missing value as NaN.

Capability parity with reference ``tools/local_mib_batch_readout.py`` (local
filesystem) and ``tools/mib_batch_readout.py`` (MinIO bucket, 10-thread
fetch, re-upload of the combined result — MinIO import-gated here).
"""

from __future__ import annotations

import csv
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..reporting import concat_tables, parse_csv_rows, rows_csv_text
from ..utils.logger import setup_logger

logger = setup_logger(__name__)

Table = Tuple[Dict[str, str], List[Dict[str, Any]]]


def _with_batch(text: str, batch: str) -> Table:
    """One file's typed table with its ``batch`` column set, as
    ``df["batch"] = ...`` sets it: last, or in place where the file has one."""
    kinds, rows = parse_csv_rows(text)
    kinds["batch"] = "str"
    for row in rows:
        row["batch"] = batch
    return kinds, rows


def combine_local_batches(
    root: Path,
    pattern: str = "batch_*/batch_data.csv",
    output: Optional[Path] = None,
    num_workers: int = 10,
) -> List[Dict[str, Any]]:
    """Concatenate ``batch_*/batch_data.csv`` under ``root``; write
    ``combined_output.csv`` (reference ``local_mib_batch_readout.py:89-140``).
    Returns the combined rows as a list of dicts (the JAX function returns
    the same table as a DataFrame)."""
    root = Path(root)
    files = sorted(root.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no files matching {pattern} under {root}")

    def read(p: Path):
        try:
            return _with_batch(p.read_text(encoding="utf-8"), p.parent.name)
        except (OSError, csv.Error, ValueError) as e:
            logger.warning("skipping %s: %s", p, e)
            return None

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        tables = [t for t in pool.map(read, files) if t is not None]
    columns, rows = concat_tables(tables)
    out = Path(output) if output else root / "combined_output.csv"
    out.write_text(rows_csv_text(rows, (), columns), encoding="utf-8")
    logger.info("combined %d batch files -> %s (%d rows)", len(tables), out, len(rows))
    return rows


def combine_minio_batches(
    bucket: str = "erb-g07",
    prefix: str = "",
    pattern_name: str = "batch_data.csv",
    endpoint: Optional[str] = None,
    num_workers: int = 10,
    upload: bool = True,
) -> List[Dict[str, Any]]:
    """MinIO-backed variant (reference ``mib_batch_readout.py:90-164``);
    returns the combined rows as a list of dicts.

    Requires the ``minio`` package (gated).
    """
    import io
    import os

    try:
        from minio import Minio  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "minio is not installed; use combine_local_batches for filesystem runs"
        ) from e

    client = Minio(
        endpoint or os.environ.get("MINIO_ENDPOINT", "localhost:9000"),
        access_key=os.environ.get("MINIO_ACCESS_KEY"),
        secret_key=os.environ.get("MINIO_SECRET_KEY"),
        secure=os.environ.get("MINIO_SECURE", "false").lower() == "true",
    )
    objects = [
        o.object_name
        for o in client.list_objects(bucket, prefix=prefix, recursive=True)
        if o.object_name.endswith(pattern_name)
    ]

    def fetch(name: str):
        resp = client.get_object(bucket, name)
        try:
            return _with_batch(resp.read().decode("utf-8"), name.rsplit("/", 2)[-2])
        finally:
            resp.close()

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        tables = list(pool.map(fetch, objects))
    columns, rows = concat_tables(tables)
    if upload:
        data = rows_csv_text(rows, (), columns).encode("utf-8")
        client.put_object(
            bucket, f"{prefix.rstrip('/')}/combined_output.csv", io.BytesIO(data), len(data)
        )
    return rows
