"""Dynamic int8 (w8a8) quantisation of the SAM encoder's projections.

Counterpart of ``yolo_sam_inference_tpu/ops/quant.py``, same scheme:

* weights: symmetric per-output-channel int8, scale ``max|w_col| / 127``
  (1 for a zero column), round half to even, clipped to +-127, made once when
  a stage set is built (:func:`quantize_linear_params`);
* activations: symmetric per-row int8 with the same rule, taken on the fly;
* products: int8 x int8 with exact integer accumulation, then
  ``acc * (row_scale * col_scale) + bias`` in fp32.

On the grid route the activation side is fused with its producer: the
kernels ``fused_ln_matmul_int8``, ``fused_ln_mlp_int8`` and
``fused_ln_mlp_tiled_int8`` in :mod:`.fused_ln`. The flat route takes the
JAX package's unfused path, whose plain version is :func:`int8_linear` here
and whose kernel wrapper is ``fused_ln.int8_linear``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def quantize_weight(w):
    """Symmetric per-output-channel int8 quantisation of an (in, out) weight.

    Returns ``(wq int8 (in, out), scale fp32 (out,))`` with ``w ~= wq * scale``.
    A numpy weight quantises in numpy, a tensor in torch; both give the JAX
    package's integers and scales bit for bit (fp32 division, half-even
    rounding)."""
    if isinstance(w, np.ndarray):
        w32 = w.astype(np.float32)
        amax = np.max(np.abs(w32), axis=0)
        scale = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
        wq = np.clip(np.round(w32 / scale), -127, 127).astype(np.int8)
        return wq, scale
    w32 = w.float()
    amax = w32.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_linear_params(p: Dict[str, Any]) -> Dict[str, Any]:
    """{"w", "b"} -> {"wq", "wscale", "b"} (drops the float weight)."""
    wq, scale = quantize_weight(p["w"])
    return {"wq": wq, "wscale": scale, "b": p["b"]}


def is_quantized(p: Dict[str, Any]) -> bool:
    """True for a linear-params record made by :func:`quantize_linear_params`."""
    return "wq" in p


def quantize_sam_encoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantise qkv, mlp1 and mlp2 of every vision layer (11/12 of a layer's
    linear FLOPs); the attention projection, the neck, the prompt encoder and
    the decoder stay float. Returns a new tree; the input is not mutated. A
    tree without a "vision" subtree is returned as it is."""
    if "vision" not in params:
        return params
    new = dict(params)
    vision = dict(params["vision"])
    layers = []
    for lp in vision["layers"]:
        lp = dict(lp)
        lp["attn"] = dict(lp["attn"])
        lp["attn"]["qkv"] = quantize_linear_params(lp["attn"]["qkv"])
        lp["mlp1"] = quantize_linear_params(lp["mlp1"])
        lp["mlp2"] = quantize_linear_params(lp["mlp2"])
        layers.append(lp)
    vision["layers"] = layers
    new["vision"] = vision
    return new


def quant_rows(v: torch.Tensor):
    """Symmetric per-row int8 quantisation of fp32 rows (..., k).

    Returns ``(q, scale)``: q holds the int8 values as fp32 integers, scale is
    (..., 1) fp32; ``v ~= q * scale``."""
    amax = v.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(v / scale), -127, 127), scale


def int_dot(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``q @ wq`` of int8-valued operands, accumulated exactly, as fp32.

    The products are summed in float64, which holds every sum of int8
    products below 2^53 exactly (fp32 would not: 127^2 * 5120 > 2^24); the
    result is then rounded to fp32 as an int32 accumulator converts."""
    return (q.double() @ wq.double()).float()


def int8_linear(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(wq) + b`` with dynamic per-row int8 activations; (..., in)
    -> (..., out) in x's dtype. The plain version of the JAX package's
    unfused int8 path."""
    shape = x.shape
    xq, xs = quant_rows(x.reshape(-1, shape[-1]).float())
    out = int_dot(xq, wq) * (xs * wscale.float()) + b.float()
    return out.to(x.dtype).reshape(*shape[:-1], wq.shape[-1])


__all__ = [
    "int8_linear", "int_dot", "is_quantized", "quant_rows", "quantize_linear_params",
    "quantize_sam_encoder_params", "quantize_weight",
]
