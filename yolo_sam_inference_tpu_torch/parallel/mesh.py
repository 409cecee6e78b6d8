"""Meshes of ranks: named axes over the ranks of a ``torch.distributed``
program, the port's counterpart of the JAX package's ``parallel/mesh.py``.

A JAX ``Mesh`` lays devices of one SPMD program out on named axes. Here a
device is a rank (one process, one card), and a :class:`RankMesh` lays
global ranks out the same way: ``make_mesh(dp=4)`` puts ranks 0-3 on the
data axis. For each axis it holds this rank's process group along that axis
(the ranks that differ from it only in that coordinate), so a data-parallel
batch gathers over ``mesh.axis_group("dp")``, the sequence-parallel encoder
splits its rows over ``mesh.axis_group("sp")`` and the tensor-parallel one its
heads and MLP hidden over ``mesh.axis_group("tp")``. Weights are not placed:
every rank builds the same ones from one seed or file and keeps what its
place on the mesh needs (``parallel/tp.py`` keeps a rank's shard).

Building a mesh creates process groups, and ``torch.distributed.new_group``
must be entered by every rank of the program in the same order: call these
functions on every rank, also on ranks that the mesh leaves out. Without a
process group there is one rank, and a mesh of extent 1 with no groups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist

def _world() -> tuple:
    """(this rank, world size) of the running process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True, eq=False)
class RankMesh:
    """Global ranks on named axes. ``ranks`` has one dimension an axis, in
    ``axis_names`` order; ``groups[axis]`` is this rank's process group along
    ``axis`` where the axis neither has extent 1 nor spans the whole mesh
    (:meth:`axis_group` gives every axis's), ``group`` the group of all the
    mesh's ranks (None where this rank is not in the mesh, or without a
    process group)."""

    axis_names: tuple
    ranks: np.ndarray
    group: object = None
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def devices(self) -> np.ndarray:
        """The ranks, named as a JAX mesh names its devices."""
        return self.ranks

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def contains(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return _world()[0] in self.ranks

    def axis_group(self, axis: str):
        """This rank's process group along ``axis``: the mesh's own group
        where the axis spans the whole mesh, None for an axis of extent 1
        in a larger mesh."""
        if self.shape[axis] == self.size:
            return self.group
        return self.groups.get(axis)

    @property
    def first(self) -> int:
        """The global rank at the mesh's origin: the one that writes files."""
        return int(self.ranks.flat[0])

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == _world()[0])
        if not len(where):
            raise ValueError(f"rank {_world()[0]} is not in the mesh {self.ranks.tolist()}")
        return int(where[0][self.axis_names.index(axis)])


def _axis_groups(ranks: np.ndarray, names: Sequence[str]) -> Dict[str, object]:
    """Every rank's line along each axis as a process group, created in one
    order on every rank (``new_group`` is collective over the program); this
    rank keeps the groups it is in."""
    me = _world()[0]
    groups: Dict[str, object] = {}
    for axis, name in enumerate(names):
        lines = np.moveaxis(ranks, axis, -1).reshape(-1, ranks.shape[axis])
        for line in lines:
            members = [int(r) for r in line]
            if len(members) == ranks.size or len(members) == 1:
                continue  # the mesh's own group (RankMesh.axis_group), or none
            g = dist.new_group(members)
            if me in members:
                groups[name] = g
    return groups


def make_mesh_axes(ranks: Optional[Sequence[int]] = None, **axes: int) -> RankMesh:
    """Mesh with arbitrary named axes, e.g. ``make_mesh_axes(dp=1, sp=4)``,
    over ``ranks`` (default: every rank of the program), laid out
    major-to-minor in keyword order: the last axis falls on consecutive
    ranks."""
    me, world = _world()
    ranks = list(range(world) if ranks is None else ranks)
    n = int(np.prod(list(axes.values())))
    if n != len(ranks):
        raise ValueError(f"{axes} needs {n} devices, have {len(ranks)}")
    arr = np.asarray(ranks, dtype=np.int64).reshape(tuple(axes.values()))
    if not (dist.is_available() and dist.is_initialized()):
        if len(ranks) > 1:
            raise ValueError(f"a mesh of {len(ranks)} ranks needs a torch.distributed process "
                             "group (parallel.launch.run_ranks starts one)")
        return RankMesh(tuple(axes), arr)
    whole = dist.group.WORLD if len(ranks) == world else dist.new_group(sorted(ranks))
    groups = _axis_groups(arr, tuple(axes))
    return RankMesh(tuple(axes), arr, whole if me in ranks else None, groups)


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              ranks: Optional[Sequence[int]] = None) -> RankMesh:
    """Create a (dp, tp) mesh over ``ranks`` (default: every rank of the
    program). With ``dp=None`` all remaining ranks go to the data axis."""
    ranks = list(range(_world()[1]) if ranks is None else ranks)
    n = len(ranks)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != {n} devices")
    return make_mesh_axes(ranks, dp=dp, tp=tp)


def make_encoder_parallel_mesh(kind: str, n_devices: int = 0,
                               ranks: Optional[Sequence[int]] = None) -> RankMesh:
    """Mesh for ``PipelineOptions(encoder_parallel=...)`` from a CLI knob: a
    (dp=1, tp=N) or (dp=1, sp=N) mesh over the first ``n_devices`` ranks
    (0 = all); the runners expose it as ``--encoder-parallel tp|sp
    --parallel-devices N``."""
    ranks = list(range(_world()[1]) if ranks is None else ranks)
    n = int(n_devices) or len(ranks)
    if n > len(ranks):
        raise ValueError(f"--parallel-devices {n} > {len(ranks)} visible devices (the ranks "
                         f"of the process group)")
    if kind == "tp":
        return make_mesh(dp=1, tp=n, ranks=ranks[:n])
    if kind == "sp":
        return make_mesh_axes(ranks[:n], dp=1, sp=n)
    raise ValueError(f"encoder_parallel mesh kind must be tp|sp, got {kind!r}")


def data_shard(mesh: RankMesh, n: int, axis: str = "dp") -> slice:
    """This rank's contiguous share of a batch of ``n`` (a multiple of the
    ``axis`` extent) along the data axis: the rows a JAX ``data_sharding``
    places on its device."""
    dp = mesh.shape[axis]
    if n % dp:
        raise ValueError(f"a batch of {n} does not divide over {axis}={dp}")
    i = mesh.index(axis)
    return slice(i * (n // dp), (i + 1) * (n // dp))


def shard_batch(mesh: RankMesh, batch):
    """This rank's share of a host batch (an array, or a dict / list / tuple
    of them, each split on its leading axis over 'dp')."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[data_shard(mesh, batch.shape[0])]


__all__ = ["RankMesh", "make_mesh", "make_mesh_axes", "make_encoder_parallel_mesh",
           "data_shard", "shard_batch"]
