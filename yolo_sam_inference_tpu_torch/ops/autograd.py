"""Gradients through the hand-written kernels.

A kernel bound through ctypes writes its result into a tensor that autograd
never saw: the output carries no ``grad_fn``, so a loss built on it would
leave every weight before it without a gradient, and nothing would say so.
Two rules close that hole:

* the kernels a training step's forward reaches (``gemm_bf16``,
  ``layer_norm``, ``window_attention``, ``flash_attention_relpos``,
  ``t2i_shared_attend``, ``i2t_keys_update``) go through
  :func:`through_kernel` on a CUDA tensor when autograd records and an
  input requires a gradient. Its forward launches the kernel (and counts the
  launch, as at inference); its backward recomputes the kernel's plain
  version from the saved inputs under ``torch.enable_grad()``, in fp32 (a
  float64 input stays float64), and returns ``torch.autograd.grad`` of that,
  each gradient cast to its input's dtype. There is no backward kernel: the
  JAX package has none either (it differentiates its plain forward);
* every other kernel entry raises on such a call (:func:`refuse_grad`).

On a CPU tensor the entries call their plain versions, which autograd
differentiates as it is.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def wants_grad(*tensors) -> bool:
    """Whether autograd records and one of ``tensors`` (None and non-tensor
    values are skipped) requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a gradient would be recorded: the call
    would return a tensor with no ``grad_fn`` and drop every gradient before
    it."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: this kernel has no gradient (only the kernels of the SAM "
                           "fine-tune step's forward do); call it under torch.no_grad() or on "
                           "tensors that require no gradient")


def _fp32_or_wider(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t.detach()
    return t.detach().to(torch.promote_types(t.dtype, torch.float32))


class _ThroughKernel(torch.autograd.Function):
    """forward: ``kernel(*args, **kwargs)``; backward: autograd of
    ``plain(*args, **kwargs)`` recomputed in fp32 on the saved inputs.
    ``spec`` and ``leaves`` rebuild (args, kwargs) with the tensors given."""

    @staticmethod
    def forward(ctx, kernel, plain, spec, leaves, slots, *tensors):
        ctx.plain, ctx.spec, ctx.leaves, ctx.slots = plain, spec, leaves, slots
        ctx.save_for_backward(*tensors)
        args, kwargs = _rebuild(spec, leaves, slots, tensors)
        return kernel(*args, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[5:]
        with torch.enable_grad():
            inputs = [_fp32_or_wider(t).requires_grad_(bool(need) and t.is_floating_point())
                      for t, need in zip(saved, needs)]
            args, kwargs = _rebuild(ctx.spec, ctx.leaves, ctx.slots, inputs)
            out = ctx.plain(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wrt = [i for i, t in enumerate(inputs) if t.requires_grad]
        res = [None] * len(saved)
        if pairs and wrt:
            got = torch.autograd.grad([o for o, _ in pairs], [inputs[i] for i in wrt],
                                      [g.to(o.dtype) for o, g in pairs], allow_unused=True)
            for i, g in zip(wrt, got):
                res[i] = None if g is None else g.to(saved[i].dtype)
        return (None, None, None, None, None, *res)


def _rebuild(spec, leaves, slots, tensors):
    leaves = list(leaves)
    for i, t in zip(slots, tensors):
        leaves[i] = t
    return pytree.tree_unflatten(leaves, spec)


def through_kernel(kernel, plain, *args, **kwargs):
    """``kernel(*args, **kwargs)`` as one autograd node whose backward is the
    autograd of ``plain`` (the same signature, the same function) at fp32.
    Tensors may sit anywhere in the arguments (inside tuples, lists and
    dicts); the rest is passed as it is. ``kernel`` runs with autograd off,
    so an entry may pass itself: inside, :func:`wants_grad` is False and it
    launches its kernel."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    slots = [i for i, leaf in enumerate(leaves) if isinstance(leaf, torch.Tensor)]
    tensors = [leaves[i] for i in slots]
    static = [None if i in slots else leaf for i, leaf in enumerate(leaves)]
    return _ThroughKernel.apply(kernel, plain, spec, static, slots, *tensors)


__all__ = ["refuse_grad", "through_kernel", "wants_grad"]
