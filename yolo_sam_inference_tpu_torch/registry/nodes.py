"""Manifest-driven incremental (resumable) batch processing.

A copy of the JAX package's ``registry/nodes.py`` (which the port may not
import), but for its decoders: MinIO objects are read by the port's own
(``web/serve.py``'s dispatch: the native PNG decoder, ``io/tiff.py``), PIL
only for the forms those do not take.

The reference shipped this only as a broken fragment documenting the design
(reference ``pipelines/inference/nodes.py:1-60``: skip rows that already have
results, fetch, process, append a JSONB-ish row, record errors per record).
This is the working implementation against any manifest (sqlite or Postgres
adapter) and any image source (filesystem loader by default; MinIO-gated).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..utils.logger import setup_logger
from ..utils.mask_encoding import encode_binary_mask
from .manifest import WorkManifest, metrics_to_result_row

logger = setup_logger(__name__)


def filesystem_fetcher(path: str) -> np.ndarray:
    from ..io.images import load_image

    return load_image(path)


def decode_rgb(data: bytes) -> np.ndarray:
    """Image bytes as RGB uint8 (H, W, 3), as PIL's ``convert("RGB")`` gives
    them: gray repeated, alpha dropped."""
    from ..io.images import _to_rgb_uint8
    from ..web.serve import _decode_image

    arr = _decode_image(data, {})
    if arr.ndim == 3 and arr.shape[2] == 2:  # gray + alpha
        arr = arr[..., 0]
    return _to_rgb_uint8(arr)


def minio_fetcher(endpoint: Optional[str] = None) -> Callable[[str], np.ndarray]:
    """Image fetcher for ``bucket/object`` paths (requires minio — gated)."""
    import os
    from urllib.parse import unquote

    try:
        from minio import Minio  # type: ignore
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("minio is not installed") from e

    client = Minio(
        endpoint or os.environ.get("MINIO_ENDPOINT", "localhost:9000"),
        access_key=os.environ.get("MINIO_ACCESS_KEY"),
        secret_key=os.environ.get("MINIO_SECRET_KEY"),
        secure=os.environ.get("MINIO_SECURE", "false").lower() == "true",
    )

    def fetch(path: str) -> np.ndarray:
        bucket, _, obj = unquote(path).partition("/")
        resp = client.get_object(bucket, obj)
        try:
            return decode_rgb(resp.read())
        finally:
            resp.close()

    return fetch


def process_pending(
    manifest: WorkManifest,
    pipeline,
    fetcher: Callable[[str], np.ndarray] = filesystem_fetcher,
    limit: Optional[int] = None,
    store_masks: bool = True,
) -> Dict[str, int]:
    """Process all pending manifest rows through the pipeline; idempotent.

    One ``process_batch_arrays`` call an image, as the JAX function makes
    them. Per-record failure isolation: an unreadable/failed image records
    its error and processing continues (reference ``nodes.py:57-59``).
    """
    pending = manifest.pending(limit)
    stats = {"processed": 0, "empty": 0, "errors": 0, "skipped_done": 0}
    for path in pending:
        try:
            image = fetcher(path)
            out = pipeline.process_batch_arrays(image[None].astype(np.uint8))
            valid = out["valid"][0]
            rows: List[Dict[str, Any]] = []
            cm = out["mask_crops"].shape[-1]
            h, w = image.shape[:2]
            for k in range(valid.shape[0]):
                if not valid[k]:
                    continue
                metrics = pipeline._metrics_row(out["metrics"], 0, k)
                mask_enc = None
                if store_masks:
                    full = np.zeros((h, w), dtype=bool)
                    r0, c0 = out["offsets"][0, k]
                    full[r0 : r0 + cm, c0 : c0 + cm] = out["mask_crops"][0, k]
                    mask_enc = encode_binary_mask(full)
                rows.append(
                    metrics_to_result_row(
                        metrics,
                        mask_encoded=mask_enc,
                        box=out["boxes"][0, k],
                        confidence=out["scores"][0, k],
                    )
                )
            manifest.record_result(path, rows, empty=not rows)
            stats["processed"] += 1
            if not rows:
                stats["empty"] += 1
        except Exception as e:
            logger.warning("failed to process %s: %s", path, e)
            manifest.record_error(path, str(e))
            stats["errors"] += 1
    return stats
