"""The collectives of the multi-rank encoders and the fine-tune step.

gloo's collectives and point-to-point run on host memory, so on gloo a CUDA
tensor is staged through a pinned host buffer (:func:`staged`) and the
result copied back to the card: the transport of the collective, not a CPU
path of the computation. It is what lets ranks share one card, where NCCL
refuses two ranks on one device. On any other backend the buffer stays on
the tensor's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


def staged(t: torch.Tensor, group, op: Callable[[torch.Tensor], Optional[torch.Tensor]],
           dtype: Optional[torch.dtype] = None) -> Optional[torch.Tensor]:
    """``op(buf)`` on a fresh buffer ``buf`` holding t's values (cast to
    ``dtype``) where the group's backend can take it; op's result (None, or
    a tensor) on t's device."""
    host = t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    buf = torch.empty(t.shape, dtype=dtype or t.dtype, device="cpu" if host else t.device,
                      pin_memory=host).copy_(t)
    out = op(buf)
    return None if out is None else out.to(t.device)


def _global_rank(group, r: int) -> int:
    """The world rank of rank ``r`` of ``group``."""
    return dist.get_global_rank(group, r) if group is not dist.group.WORLD else r


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The group's tensors of t's shape summed in fp32 (an fp32 tensor on
    t's device)."""
    def op(buf):
        dist.all_reduce(buf, group=group)
        return buf

    return staged(t, group, op, torch.float32)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors of t's shape, concatenated along ``dim`` in rank
    order."""
    def op(buf):
        parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, buf, group=group)
        return torch.cat(parts, dim)

    return staged(t, group, op)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank ``src``'s t (of the group) on every rank."""
    def op(buf):
        dist.broadcast(buf, _global_rank(group, src), group=group)
        return buf

    return staged(t, group, op)


def send(t: torch.Tensor, dst: int, group) -> None:
    staged(t, group, lambda buf: dist.send(buf, _global_rank(group, dst), group=group))


def recv(shape, dtype, device, src: int, group) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` from rank ``src`` of the group, on
    ``device``."""
    def op(buf):
        dist.recv(buf, _global_rank(group, src), group=group)
        return buf

    return staged(torch.empty(shape, dtype=dtype, device=device), group, op)


__all__ = ["all_gather", "all_reduce_sum", "broadcast", "recv", "send", "staged"]
