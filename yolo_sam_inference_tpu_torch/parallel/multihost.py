"""Scaling over processes: file-list sharding + per-rank CSV shards.

The port's counterpart of the JAX package's ``parallel/multihost.py``. A
JAX host is a process with its chips; here a rank is a process with its
card, and the rank and world size come from the running
``torch.distributed`` process group (:func:`process_info`, ``(0, 1)``
without one) instead of ``jax.process_index()``. Every rank strides the
global file list by its rank (no image bytes move between ranks, only the
small CSV shards are merged at the end), runs its own single-card pipeline
over its files, and rank 0 concatenates the CSV shards. No pandas: the
shards are read, joined and written as ``pandas.read_csv``, ``concat`` and
``to_csv`` would (``reporting.py``), the JAX function's bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

import torch.distributed as dist

from ..reporting import concat_tables, read_csv_rows, write_rows_csv
from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def process_info():
    """(rank, world size) of the running process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_file_list(files: Sequence[Path], index: Optional[int] = None,
                    count: Optional[int] = None) -> List[Path]:
    """This rank's stride-sharded slice of the global (sorted) file list."""
    if index is None or count is None:
        index, count = process_info()
    files = sorted(files)
    return list(files[index::count])


def shard_csv_path(output_dir: Path, name: str = "cell_metrics",
                   index: Optional[int] = None) -> Path:
    if index is None:
        index, _ = process_info()
    return Path(output_dir) / f"{name}.shard{index:04d}.csv"


def merge_csv_shards(output_dir: Path, name: str = "cell_metrics",
                     remove_shards: bool = False) -> Optional[Path]:
    """Rank 0: concatenate ``{name}.shard*.csv`` -> ``{name}.csv``, after a
    barrier that waits for every rank's shard (call it on every rank; the
    others return None)."""
    index, count = process_info()
    if count > 1:
        dist.barrier()
    if index != 0:
        return None
    output_dir = Path(output_dir)
    shards = sorted(output_dir.glob(f"{name}.shard*.csv"))
    if not shards:
        return None
    columns, rows = concat_tables([read_csv_rows(s) for s in shards])
    out = output_dir / f"{name}.csv"
    write_rows_csv(rows, (), out, columns)
    if remove_shards:
        for s in shards:
            s.unlink()
    logger.info("merged %d shards -> %s (%d rows)", len(shards), out, len(rows))
    return out


def run_sharded_directory(pipeline, input_dir: Path, output_dir: Path,
                          save_visualizations: bool = False):
    """Process this rank's shard of a directory; write per-rank CSV shards.

    Files are sharded over the ranks of the process group, so ``pipeline``
    is this rank's own single-card pipeline (no ``mesh=``: a mesh's ranks
    all take the same frames). The ranks take rank 0's run id, so every
    shard lands in one run directory. Call :func:`merge_csv_shards`
    afterwards (on every rank) for the global CSVs.
    """
    from ..io.images import list_image_files

    if getattr(pipeline, "mesh", None) is not None and pipeline.mesh.size > 1:
        raise ValueError("run_sharded_directory shards files over the ranks: give each rank a "
                         "pipeline without mesh=")
    index, count = process_info()
    if count > 1:
        box = [pipeline.run_id]
        dist.broadcast_object_list(box, src=0)
        pipeline.run_id = box[0]
    files = shard_file_list(list_image_files(Path(input_dir), recursive=True))
    logger.info("rank %d/%d: %d files in shard", index, count, len(files))
    batch = pipeline.process_directory(
        input_dir, output_dir, save_visualizations=save_visualizations,
        image_paths=files,
    )
    run_dir = Path(output_dir) / pipeline.run_id
    # DataFrame(rows).to_csv(index=False), as the JAX function writes them
    if batch.metrics_data:
        write_rows_csv(batch.metrics_data, (), shard_csv_path(run_dir, "cell_metrics", index))
    if batch.timing_data:
        write_rows_csv(batch.timing_data, (), shard_csv_path(run_dir, "processing_times", index))
    return batch
