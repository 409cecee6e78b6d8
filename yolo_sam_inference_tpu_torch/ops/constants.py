"""Constant tensors made on a device once and kept.

A constant built from host values on every call (``torch.tensor(values,
device=dev)``, ``torch.from_numpy(a).to(dev)``) is a copy from pageable host
memory, and on a CUDA device that copy waits until the card has finished all
the work queued before it: one such copy in a stage drains every batch in
flight. A function under :func:`made_once` makes its tensor on the first call
for a key (its arguments: values or sizes, dtype, device) and returns the same
tensor on every later call, so the stages copy nothing after their first batch.

The tensors are ordinary ones, made with inference mode off, so callers in and
out of ``torch.inference_mode`` and autograd use them alike. Every caller
shares them: nothing writes into them.
"""

from __future__ import annotations

import functools

import torch


def made_once(maxsize: int):
    """Decorator: the function's result cached on its positional arguments
    (at most ``maxsize`` keys), computed with inference mode off."""

    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(fn)
        def once(*args):
            with torch.inference_mode(False):
                return fn(*args)

        return once

    return wrap


@made_once(maxsize=256)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, ``values`` a
    number or a tuple of numbers."""
    return torch.tensor(values, dtype=dtype, device=device)


__all__ = ["constant", "made_once"]
