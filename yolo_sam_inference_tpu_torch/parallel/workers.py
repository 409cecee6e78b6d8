"""Rank functions for :func:`.launch.run_ranks` that read their inputs from
files and write one result file per rank, so the parent can hold them
against the single-device port or the JAX package without importing either
into the ranks.

``run_jobs(rank, world, jobs)`` runs each job of the list in order. A job
with ``"ranks": n`` runs on ranks ``0..n-1`` over a group of their own (the
others go on to the next job); without it, on every rank. A job is a dict:

* ``{"kind": "encoder", "tree": .npz, "cfg": SamTPUConfig, "pix": .npy,
  "out": prefix}``: the ``"vision"`` subtree as a ``SamImageEncoder`` (in
  fp32 on the CPU, or on ``"device"`` in ``"dtype"``),
  :func:`~.sp.sam_image_encoder_sp` on the pixels; ``{prefix}.rank{r}.npy``
  holds the embeddings in fp32;
* ``{"kind": "pipeline", "kwargs": dict, "frames": .npy, "out": prefix}``:
  ``CellSegmentationPipeline(**kwargs)`` (its options set
  ``encoder_parallel="sp"``) on the frames; ``{prefix}.rank{r}.npz`` holds
  the outputs of ``process_batch_arrays`` (metrics as ``metric_<key>``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _encoder_job(rank: int, job: dict, group) -> None:
    from ..models.sam import SamImageEncoder
    from ..weights import load_tree
    from .sp import sam_image_encoder_sp

    dev, dtype = torch.device(job.get("device", "cpu")), job.get("dtype", torch.float32)
    enc = SamImageEncoder(load_tree(job["tree"])["vision"], job["cfg"]).to(dev, dtype)
    pix = torch.from_numpy(np.load(job["pix"])).to(dev, dtype)
    with torch.inference_mode():
        emb = sam_image_encoder_sp(enc, pix, job["cfg"], group)
    np.save(f"{job['out']}.rank{rank}.npy", emb.float().cpu().numpy())


def _pipeline_job(rank: int, job: dict, group) -> None:
    from ..pipeline.engine import CellSegmentationPipeline

    pipe = CellSegmentationPipeline(**job["kwargs"], process_group=group)
    out = pipe.process_batch_arrays(np.load(job["frames"]))
    arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
    arrays.update({f"metric_{k}": v for k, v in out["metrics"].items()})
    np.savez(f"{job['out']}.rank{rank}.npz", **arrays)


def run_jobs(rank: int, world: int, jobs) -> None:
    torch.set_num_threads(1)
    for job in jobs:
        n = job.get("ranks", world)
        group = dist.new_group(list(range(n))) if n < world else dist.group.WORLD  # on every rank
        if rank < n:
            {"encoder": _encoder_job, "pipeline": _pipeline_job}[job["kind"]](rank, job, group)


__all__ = ["run_jobs"]
