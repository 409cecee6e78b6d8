"""Host-side async image loading and batch assembly.

Replaces the reference's per-image synchronous ``cv2.imread`` in the hot
loop (reference ``pipeline.py:206-210, 244``) and its thread-replica
parallelism (``pipeline.py:562-566``) with a prefetching loader: a thread
pool decodes images ahead of the device, batches are grouped by image shape
(static shapes per compiled program), and partial batches are padded with a
validity count. A copy of the JAX package's ``pipeline/loader.py`` (which
the port may not import); a PNG decoder that cannot be built is an error of
the run, not an unreadable image.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io.images import load_image_collapsed
from ..io.png_native import NativeBuildError
from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def batched_image_loader(
    files: Sequence[Path],
    batch_size: int,
    num_workers: Optional[int] = None,
    skipped_report: "Optional[Path]" = None,
) -> Iterator[Tuple[np.ndarray, List[Path], int, float]]:
    """Yield (batch uint8, paths, n_valid, load_seconds); the batch is
    (B, H, W, 3) for true-RGB sources or (B, H, W) for replicated-RGB
    grayscale sources (collapsed at decode — see ``_safe_load``; the
    engine's device paths accept both ranks).

    Images are decoded concurrently and grouped by their decoded shape so
    every yielded batch has a uniform static shape; the final partial batch
    of each group is padded by repeating its first image (n_valid marks the
    real count).
    Corrupt/zero-byte images are skipped and, when ``skipped_report`` is
    given, audited to a ``skipped_images.txt`` file (the reference's
    validation behavior, ``examples/mlflow_example_project_inference.py:178-234``).
    """
    files = list(files)
    if not files:
        return
    if num_workers is None:
        # decode threads only pay off up to the core count (8 threads on a
        # 1-core host measured pure contention overhead)
        import os as _os

        num_workers = max(1, min(8, _os.cpu_count() or 1))

    def emit(items, load_s_per_img):
        n_valid = len(items)
        imgs = [img for _, img in items]
        paths = [p for p, _ in items]
        while len(imgs) < batch_size:
            imgs.append(imgs[0])
        # np.stack alone — a trailing .astype(uint8) re-copied the whole
        # batch (~100 MB at B=128) for nothing on this single-core host
        batch = np.stack(imgs)
        return batch, paths, n_valid, load_s_per_img * n_valid

    # Stream in bounded chunks (decode-ahead = a few batches), grouping by
    # shape within each chunk — constant memory even for 100k-image sweeps.
    # Images of a shape left over at a chunk boundary carry into the next
    # chunk so full batches still form across chunks.
    chunk_files = batch_size * 4
    pending: dict = {}  # shape -> [(path, img)]
    skipped: List[str] = []
    # single-worker pools measured ~2.4 ms/img of pure queue/switch overhead
    # on a 1-core host (vs 6.3 ms of actual decode) — decode inline instead;
    # process_directory's prefetch thread still overlaps device compute.
    # E2E_DECODE_PROCS=N opts into a PROCESS pool, for decodes that hold
    # the GIL (PIL's, where it takes a form the native decoder does not):
    # processes decode truly concurrently (pickle cost is one (H, W) uint8
    # array per image, small next to the decode).
    import os as _os
    from contextlib import nullcontext

    n_procs = int(_os.environ.get("E2E_DECODE_PROCS", "0"))
    if n_procs > 0:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # spawn, never fork: a forked child would inherit the caller's CUDA
        # context and the locks of its live threads (prefetch, the CUDA
        # runtime's) mid-acquisition
        pool_cm = ProcessPoolExecutor(
            max_workers=n_procs,
            mp_context=multiprocessing.get_context("spawn"),
        )
    elif num_workers > 1:
        pool_cm = ThreadPoolExecutor(max_workers=num_workers)
    else:
        pool_cm = nullcontext()
    with pool_cm as pool:
        if n_procs > 0:
            decode = lambda fn, it: pool.map(fn, it, chunksize=8)
        else:
            decode = pool.map if num_workers > 1 else map
        # Yield each batch the moment it fills (NOT after the whole decode
        # chunk): the consumer's first dispatch happens after batch_size
        # decodes instead of chunk_files — decoding a full 4-batch chunk
        # up front left the device idle ~1.3 s at the head of every
        # directory run and delivered batches in bursts that overflowed
        # the prefetch queue's smoothing.
        t_mark = time.time()
        for start in range(0, len(files), chunk_files):
            chunk = files[start : start + chunk_files]
            for path, img in zip(chunk, decode(_safe_load, chunk)):
                if img is None or img.size == 0:
                    logger.warning("Skipping unreadable image: %s", path)
                    skipped.append(str(path))
                    continue
                items = pending.setdefault(img.shape, [])
                items.append((path, img))
                if len(items) >= batch_size:
                    # decode seconds since the last yield (consumer
                    # queue-block time excluded: t_mark resets after yield)
                    load_s = time.time() - t_mark
                    yield emit(items[:batch_size], load_s / batch_size)
                    del items[:batch_size]
                    if not items:
                        del pending[img.shape]
                    t_mark = time.time()
    # final partial batches (the accumulated tail decode time goes to the
    # first; emit scales per-image attribution by n_valid)
    rest = [items for items in pending.values() if items]
    for i, items in enumerate(rest):
        load_s = (time.time() - t_mark) if i == 0 else 0.0
        yield emit(items, load_s / max(len(items), 1))

    if skipped and skipped_report is not None:
        skipped_report.parent.mkdir(parents=True, exist_ok=True)
        with open(skipped_report, "a") as f:
            f.write("\n".join(skipped) + "\n")


def _safe_load(path: Path):
    # single-channel sources (stored grayscale OR replicated-RGB microscopy)
    # decode straight to (H, W): batches stack 3x smaller, and the engine's
    # host->device copy drops 3x.
    # Shape-grouping keeps collapsed and true-RGB images in separate
    # batches; the device re-broadcasts to RGB for free (_ensure_rgb).
    try:
        return load_image_collapsed(path)
    except NativeBuildError:
        raise
    except Exception as e:  # corrupt/zero-byte images are skipped, not fatal
        logger.warning("Failed to load %s: %s", path, e)
        return None


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run a generator on a background thread with a bounded queue, so image
    decode overlaps device compute (double buffering)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # propagate errors to the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
