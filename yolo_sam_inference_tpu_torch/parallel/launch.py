"""Start the ranks of a ``torch.distributed`` program on this host.

    run_ranks(fn, world, args)  # fn(rank, world, *args) in each of `world` processes

Each rank is a process of its own (``torch.multiprocessing.spawn``), so
``fn`` must be importable by name (a module-level function). The ranks meet
through a ``FileStore`` in a temporary directory: no TCP port to pick, and
no collision between concurrent runs. Rank r uses ``cuda:{r %
device_count}``. The backend is NCCL when there are at least ``world``
cards, else gloo (NCCL refuses two ranks on one card; with gloo they share
it, their collectives staged through host memory). The kernels are built in
the parent first, so ranks never compile into one build directory at once.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def pick_backend(world: int) -> str:
    """``"nccl"`` when each rank can have a card of its own, else ``"gloo"``."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, fn, world: int, backend: str, store_path: str, args: tuple) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    # one host: gloo's pairs connect over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=()) -> str:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks and wait for all of
    them; a failure in any rank raises here. Returns the backend used
    (:func:`pick_backend`)."""
    backend = pick_backend(world)
    if torch.cuda.is_available():
        from ..ops import _build

        _build.build()
    print(f"[launch] {world} ranks over {backend}, {torch.cuda.device_count()} CUDA device(s)",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world, backend, os.path.join(tmp, "store"), tuple(args)),
                 nprocs=world, join=True)
    return backend


__all__ = ["pick_backend", "run_ranks"]
