"""Rank functions for :func:`.launch.run_ranks` that read their inputs from
files and write one result file per rank, so the parent can hold them
against the single-device port or the JAX package without importing either
into the ranks.

``run_jobs(rank, world, jobs)`` runs each job of the list in order. A job
with ``"ranks": n`` runs on ranks ``0..n-1`` over a group of their own (the
others go on to the next job); without it, on every rank. A job with
``"mesh"`` gets a :class:`~.mesh.RankMesh` over its ranks, built on every
rank (``new_group`` is collective): ``{"dp": 2}`` or any axes of
``make_mesh_axes``, or ``{"encoder_parallel": "sp", "devices": n}`` for
``make_encoder_parallel_mesh``. A job is a dict:

* ``{"kind": "encoder", "tree": .npz, "cfg": SamTPUConfig, "pix": .npy,
  "out": prefix[, "parallel": "sp" | "tp" | "pp", "microbatches": M]}``:
  the ``"vision"`` subtree (the rank's tp shard, or its pp stage) as a
  ``SamImageEncoder`` (in fp32 on the CPU, or on ``"device"`` in
  ``"dtype"``), the sp (default), tp or pp encoder on the pixels (under a
  mesh with a 'dp' axis, the rank's dp share of them, its encoder group the
  mesh's 'tp' axis); ``{prefix}.rank{r}.npy`` holds the embeddings in fp32,
  ``{prefix}.rank{r}.json`` the shapes of the rank's layer-0 weights;
* ``{"kind": "pipeline", "kwargs": dict, "frames": .npy, "out": prefix}``:
  ``CellSegmentationPipeline(**kwargs)`` (its options set
  ``encoder_parallel="sp"``) on the frames; ``{prefix}.rank{r}.npz`` holds
  the outputs of ``process_batch_arrays`` (metrics as ``metric_<key>``);
* ``{"kind": "dp", "mesh": {"dp": n}, "kwargs": dict, "frames": [.npy, ...],
  "out": prefix[, "dir": images, "outdir": dir]}``: the pipeline with
  ``mesh=`` on each frames file (``{prefix}.rank{r}.npz``, keys
  ``<i>/<output>``), then, with ``"dir"``, ``process_directory`` into
  ``"outdir"``; ``{prefix}.rank{r}.json`` holds the run id, ``writes``
  and each image's rows;
* ``{"kind": "sharded", "kwargs": dict, "dir": images, "outdir": dir,
  "out": prefix}`` (on every rank: the files are sharded over the
  program's ranks): ``parallel.multihost.run_sharded_directory`` with the
  rank's own pipeline, then ``merge_csv_shards`` of both CSVs;
  ``{prefix}.rank{r}.json`` holds the run id, the shard's files and rank 0's
  merged paths;
* ``{"kind": "train", "cfg": SamTPUConfig, "seed": int, "batch": .npz,
  "steps": n, "out": prefix[, "mesh": {...}]}``: ``parallel.train`` on the
  CPU in fp32, n steps on the batch; ``{prefix}.rank{r}.json`` holds the
  losses, ``{prefix}.rank{r}.npz`` the rank's own parameters (its tp shard),
  ``{prefix}.whole.npz`` (rank 0) the gathered tree by ``utils/checkpoint.py``,
  ``{prefix}.grads1.npz`` (rank 0) step 1's gradients gathered likewise;
* ``{"kind": "dryrun", "device": "cpu", "out": prefix}`` (on every rank):
  ``parallel.dryrun``'s five parts; ``{prefix}.rank{r}.json`` holds the
  parts run and the two losses;
* ``{"kind": "mesh_checks", "out": prefix}``: the meshes of
  ``parallel/mesh.py`` on every rank: shapes, groups and the errors;
  ``{prefix}.rank{r}.json``;
* ``{"kind": "app", "app": "single_batch_inference" | "project_inference",
  "args": Namespace, "pipeline_kwargs": dict, "mesh": {...}, ...}``: that
  runner's ``run_rank(args, pipeline_kwargs, mesh, ...)`` with the job's
  other keys (the runners' ``--encoder-parallel sp`` ranks).
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import torch
import torch.distributed as dist


def _encoder_job(rank: int, job: dict, group, mesh) -> None:
    from ..models.sam import SamImageEncoder
    from ..weights import load_tree
    from .mesh import shard_batch
    from .pp import sam_image_encoder_pp, stage_tree
    from .sp import sam_image_encoder_sp
    from .tp import sam_image_encoder_tp, shard_sam_encoder_tp

    cfg, kind = job["cfg"], job.get("parallel", "sp")
    dev, dtype = torch.device(job.get("device", "cpu")), job.get("dtype", torch.float32)
    tree, pix = load_tree(job["tree"]), np.load(job["pix"])
    if mesh is not None:
        pix = shard_batch(mesh, pix)
        group = mesh.axis_group(kind)
    n, index = dist.get_world_size(group), dist.get_rank(group)
    if kind == "tp":
        tree = shard_sam_encoder_tp(tree, cfg, n, index)
    elif kind == "pp":
        tree = stage_tree(tree, cfg, n, index)
    enc = SamImageEncoder(tree["vision"], cfg).to(dev, dtype)
    pix = torch.from_numpy(pix).to(dev, dtype)
    with torch.inference_mode():
        if kind == "tp":
            emb = sam_image_encoder_tp(enc, pix, cfg, group)
        elif kind == "pp":
            emb = sam_image_encoder_pp(enc, pix, cfg, group, job.get("microbatches"))
        else:
            emb = sam_image_encoder_sp(enc, pix, cfg, group)
    np.save(f"{job['out']}.rank{rank}.npy", emb.float().cpu().numpy())
    layer = enc.layers[0]
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump({"layers": len(enc.layers), "qkv": list(layer.qkv.w.shape),
                   "proj": list(layer.proj.w.shape), "mlp1": list(layer.mlp1.w.shape),
                   "mlp2": list(layer.mlp2.w.shape)}, f)


def _arrays(out: dict, prefix: str = "") -> dict:
    """``process_batch_arrays`` outputs as npz entries (metrics as
    ``metric_<key>``, mask crops left out where they were not fetched)."""
    arrays = {prefix + k: v for k, v in out.items() if isinstance(v, np.ndarray)}
    arrays.update({f"{prefix}metric_{k}": v for k, v in out["metrics"].items()})
    return arrays


def _pipeline_job(rank: int, job: dict, group, mesh) -> None:
    from ..pipeline.engine import CellSegmentationPipeline

    pipe = CellSegmentationPipeline(**job["kwargs"], process_group=group)
    out = pipe.process_batch_arrays(np.load(job["frames"]))
    np.savez(f"{job['out']}.rank{rank}.npz", **_arrays(out))


def _rows(batch) -> list:
    return [[r.image_path, r.cell_metrics] for r in batch.results]


def _dp_job(rank: int, job: dict, group, mesh) -> None:
    from ..pipeline.engine import CellSegmentationPipeline

    pipe = CellSegmentationPipeline(**job["kwargs"], mesh=mesh)
    arrays = {}
    for i, path in enumerate(job["frames"]):
        arrays.update(_arrays(pipe.process_batch_arrays(np.load(path)), f"{i}/"))
    np.savez(f"{job['out']}.rank{rank}.npz", **arrays)
    info = {"run_id": pipe.run_id, "writes": pipe.writes}
    if "dir" in job:
        info["rows"] = _rows(pipe.process_directory(job["dir"], job["outdir"], progress=False))
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump(info, f)


def _sharded_job(rank: int, job: dict, group, mesh) -> None:
    from ..io.images import list_image_files
    from ..pipeline.engine import CellSegmentationPipeline
    from .multihost import merge_csv_shards, run_sharded_directory, shard_file_list

    pipe = CellSegmentationPipeline(**job["kwargs"])
    batch = run_sharded_directory(pipe, job["dir"], job["outdir"])
    run_dir = f"{job['outdir']}/{pipe.run_id}"
    merged = [merge_csv_shards(run_dir, name) for name in ("cell_metrics", "processing_times")]
    files = shard_file_list(list_image_files(job["dir"], recursive=True))
    info = {"run_id": pipe.run_id, "rows": _rows(batch), "files": [str(p) for p in files],
            "merged": [None if m is None else str(m) for m in merged]}
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump(info, f)


def _train_job(rank: int, job: dict, group, mesh) -> None:
    from ..utils.checkpoint import flatten_tree, save_params_npz
    from .train import gather_params, make_train_state, sam_decoder_train_step

    cfg = job["cfg"]
    state = make_train_state(job["seed"], cfg, mesh, device="cpu")
    with np.load(job["batch"]) as z:
        batch = dict(z)
    losses = []
    for step in range(job["steps"]):
        state, loss = sam_decoder_train_step(state, batch, cfg)
        losses.append(loss)
        if step == 0:
            grads = gather_params(state, grads=True)
            if rank == 0:
                save_params_npz(grads, f"{job['out']}.grads1.npz")
    np.savez(f"{job['out']}.rank{rank}.npz",
             **{k: p.detach().numpy() for k, p in state["params"].items()})
    whole = gather_params(state)
    if rank == 0:
        save_params_npz(whole, f"{job['out']}.whole.npz")
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump({"losses": losses, "keys": sorted(flatten_tree(whole))}, f)


def _dryrun_job(rank: int, job: dict, group, mesh) -> None:
    from .dryrun import _dryrun_rank

    info = _dryrun_rank(rank, dist.get_world_size(), job.get("device", "cpu"))
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump(info, f)


def _mesh_checks_job(rank: int, job: dict, group, mesh) -> None:
    from .mesh import make_encoder_parallel_mesh, make_mesh

    world = dist.get_world_size()
    info = {}
    meshes = {"all": make_mesh(), "dp2": make_mesh(dp=2, ranks=range(2)),
              "sp_all": make_encoder_parallel_mesh("sp", 0),
              "sp2": make_encoder_parallel_mesh("sp", 2),
              "tp2": make_mesh(dp=world // 2, tp=2),
              "ep_tp": make_encoder_parallel_mesh("tp", 2)}
    for name, m in meshes.items():
        info[name] = {"shape": m.shape, "size": m.size, "contains": m.contains,
                      "first": m.first,
                      "groups": {a: (None if m.axis_group(a) is None
                                     else dist.get_world_size(m.axis_group(a)))
                                 for a in m.axis_names if m.contains},
                      "index": {a: m.index(a) for a in m.axis_names if m.contains}}
    for name, fn in {"dp3": lambda: make_mesh(dp=3),
                     "ep_many": lambda: make_encoder_parallel_mesh("sp", 99),
                     "ep_bogus": lambda: make_encoder_parallel_mesh("bogus", 2)}.items():
        try:
            fn()
            info[name] = None
        except ValueError as e:
            info[name] = str(e)
    with open(f"{job['out']}.rank{rank}.json", "w") as f:
        json.dump(info, f)


def _app_job(rank: int, job: dict, group, mesh) -> None:
    app = importlib.import_module(f"..apps.{job['app']}", __package__)
    extra = {k: v for k, v in job.items()
             if k not in ("kind", "app", "args", "pipeline_kwargs", "mesh", "ranks")}
    app.run_rank(job["args"], job.get("pipeline_kwargs"), mesh, **extra)


JOBS = {"encoder": _encoder_job, "pipeline": _pipeline_job, "dp": _dp_job,
        "sharded": _sharded_job, "mesh_checks": _mesh_checks_job, "app": _app_job,
        "train": _train_job, "dryrun": _dryrun_job}


def _job_mesh(spec, n: int):
    """The job's mesh over ranks 0..n-1 (on every rank of the program)."""
    from .mesh import make_encoder_parallel_mesh, make_mesh_axes

    if spec is None:
        return None
    spec = dict(spec)
    if "encoder_parallel" in spec:
        return make_encoder_parallel_mesh(spec["encoder_parallel"], spec.get("devices", 0),
                                          ranks=range(n))
    return make_mesh_axes(range(n), **spec)


def run_jobs(rank: int, world: int, jobs) -> None:
    torch.set_num_threads(1)
    for job in jobs:
        n = job.get("ranks", world)
        group = dist.new_group(list(range(n))) if n < world else dist.group.WORLD  # on every rank
        mesh = _job_mesh(job.get("mesh"), n)
        if rank < n:
            JOBS[job["kind"]](rank, job, group, mesh)


__all__ = ["run_jobs", "JOBS"]
