"""Tensor-parallel SAM image encoder over a ``torch.distributed`` group.

Counterpart of ``yolo_sam_inference_tpu/parallel/tp.py``: each layer's heads
and MLP hidden are split over the group's ``tp`` ranks (Megatron's
partitioning), two all-reduces a layer. Rank r of the group keeps only its
shard (:func:`shard_sam_encoder_tp`):

* qkv: the columns of its head group ``[r hl, (r + 1) hl)`` (``hl = heads /
  tp``), laid out ``(C, 3, hl, hd) -> (C, 3 hl hd)`` so the attention kernels
  see an ordinary fused qkv of ``hl`` heads; its bias likewise;
* proj: the rows of its head group (row parallel, no bias on the rank);
* mlp1: its ``mlp_dim / tp`` columns and their bias slice; mlp2: the same
  rows (row parallel);
* the rel-pos tables (no per-head parameter), LayerNorms, patch and
  positional embedding, the neck and the two row-parallel biases whole.

The layers run on the encoder's own loops (``SamImageEncoder.blocks``) with
a :class:`TPGroup` hook. Per layer on the kernels: K1 (LN1 + the local qkv);
the window attention (K3) on ``hl`` heads, or K12 on the flat route; the
local projection on ``gemm_bf16`` without bias, then the all-reduce over the
group, then ``+ proj_b + x``; ``gemm_bf16(x, w1, b1, ln=LN2, gelu=True)``;
``gemm_bf16(h, w2)``, then the all-reduce, then ``+ b2 + x``
(``VisionLayer._tail_tp``). K4's single launch cannot serve here: the MLP's
output is a partial sum. The partials are summed in fp32 (on gloo through
pinned host buffers, :mod:`.comm`, which lets the ranks share one card).

:class:`CopyToTP` and :class:`ReduceFromTP` are Megatron's pair (identity
forward / all-reduce backward, and the converse), so that the fine-tune
step (``parallel/train.py``) differentiates the same code. Every rank of the
group returns the same ``(B, gs, gs, C)`` embeddings.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from ..ops.quant import is_quantized
from .comm import all_reduce_sum

Params = Dict[str, Any]


class CopyToTP(torch.autograd.Function):
    """Megatron's f: the replicated activation into a column-parallel
    product; identity forward, the gradient all-reduced over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group).to(g.dtype), None


class ReduceFromTP(torch.autograd.Function):
    """Megatron's g: a row-parallel product's partial sums all-reduced over
    ``group`` (fp32 out); the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class TPGroup:
    """Megatron's f and g over a process group: the hook through which the
    encoder's layers run a rank's shard."""

    def __init__(self, group):
        self.group, self.size = group, dist.get_world_size(group)

    def copy(self, x):
        return CopyToTP.apply(x, self.group)

    def reduce(self, partial):
        return ReduceFromTP.apply(partial, self.group)


# A layer's replicated leaves that a rank applies to its own heads or hidden
# columns alone, so that its gradient there is its share of the whole (the
# fine-tune step sums it over the group): the rel-pos tables on both routes,
# and on the grid route the LayerNorms too, which K1 and mlp1's GEMM fuse
# behind Megatron's f (the flat route runs them before it, on every rank).
PARTIAL_GRAD_LEAVES = ("attn::rel_pos_h", "attn::rel_pos_w")
PARTIAL_GRAD_LEAVES_GRID = PARTIAL_GRAD_LEAVES + ("ln1::scale", "ln1::bias", "ln2::scale",
                                                  "ln2::bias")


def check_tp(cfg, tp: int) -> None:
    """Raises as JAX ``tp.py:72-75`` where ``tp`` does not divide the heads
    and the MLP hidden."""
    if cfg.vision_heads % tp or cfg.vision_mlp_dim % tp:
        raise ValueError(f"tp={tp} must divide heads={cfg.vision_heads} and "
                         f"mlp_dim={cfg.vision_mlp_dim}")


def shard_layer(lp: Params, cfg, tp: int, index: int) -> Params:
    """One vision layer's tree (JAX layout, numpy or torch leaves) -> shard
    ``index`` of ``tp`` in the layout of a layer with ``heads / tp`` heads and
    ``mlp_dim / tp`` hidden: qkv ``(C, 3 hl hd)``, proj ``(hl hd, C)`` with the
    whole bias, mlp1 ``(C, H / tp)`` with its bias slice, mlp2 ``(H / tp, C)``
    with the whole bias."""
    heads, c = cfg.vision_heads, cfg.vision_hidden
    hd, hl = c // heads, heads // tp
    hid = cfg.vision_mlp_dim // tp
    a = lp["attn"]
    if is_quantized(a["qkv"]) or is_quantized(lp["mlp1"]):
        raise ValueError("encoder_parallel does not compose with quant='int8' yet (the tp "
                         "sharder reads float {'w','b'} records): pick one")
    heads_sl, hid_sl = slice(index * hl, (index + 1) * hl), slice(index * hid, (index + 1) * hid)
    qkv_w = a["qkv"]["w"].reshape(c, 3, heads, hd)[:, :, heads_sl].reshape(c, 3 * hl * hd)
    qkv_b = a["qkv"]["b"].reshape(3, heads, hd)[:, heads_sl].reshape(3 * hl * hd)
    rows = slice(index * hl * hd, (index + 1) * hl * hd)
    return {
        "ln1": lp["ln1"], "ln2": lp["ln2"],
        "attn": {"qkv": {"w": qkv_w, "b": qkv_b},
                 "proj": {"w": a["proj"]["w"][rows], "b": a["proj"]["b"]},
                 "rel_pos_h": a["rel_pos_h"], "rel_pos_w": a["rel_pos_w"]},
        "mlp1": {"w": lp["mlp1"]["w"][:, hid_sl], "b": lp["mlp1"]["b"][hid_sl]},
        "mlp2": {"w": lp["mlp2"]["w"][hid_sl], "b": lp["mlp2"]["b"]},
    }


def unshard_layers(shards: list, cfg) -> Params:
    """The inverse of :func:`shard_layer` over every shard, in index order
    (numpy leaves): one layer's whole tree."""
    heads, c = cfg.vision_heads, cfg.vision_hidden
    hd, tp = c // heads, len(shards)
    hl = heads // tp
    first = shards[0]
    a0 = first["attn"]
    qkv_w = np.concatenate([np.asarray(s["attn"]["qkv"]["w"]).reshape(c, 3, hl, hd)
                            for s in shards], axis=2).reshape(c, 3 * c)
    qkv_b = np.concatenate([np.asarray(s["attn"]["qkv"]["b"]).reshape(3, hl, hd)
                            for s in shards], axis=1).reshape(3 * c)
    return {
        "ln1": first["ln1"], "ln2": first["ln2"],
        "attn": {"qkv": {"w": qkv_w, "b": qkv_b},
                 "proj": {"w": np.concatenate([s["attn"]["proj"]["w"] for s in shards]),
                          "b": a0["proj"]["b"]},
                 "rel_pos_h": a0["rel_pos_h"], "rel_pos_w": a0["rel_pos_w"]},
        "mlp1": {"w": np.concatenate([s["mlp1"]["w"] for s in shards], axis=1),
                 "b": np.concatenate([s["mlp1"]["b"] for s in shards])},
        "mlp2": {"w": np.concatenate([s["mlp2"]["w"] for s in shards]),
                 "b": first["mlp2"]["b"]},
    }


def shard_sam_encoder_tp(params: Params, cfg, tp: int, index: int) -> Params:
    """The SAM tree with its ``"vision"`` subtree cut to shard ``index`` of
    ``tp`` (every layer by :func:`shard_layer`; the embeddings and the neck
    whole); the other subtrees as they are. Requires ``heads % tp == 0`` and
    ``mlp_dim % tp == 0``; int8 weights raise, as in JAX."""
    check_tp(cfg, tp)
    v = params["vision"]
    vision = {k: val for k, val in v.items() if k != "layers"}
    vision["layers"] = [shard_layer(lp, cfg, tp, index) for lp in v["layers"]]
    return {**params, "vision": vision}


def sam_image_encoder_tp(encoder, pix: torch.Tensor, cfg, group=None) -> torch.Tensor:
    """Tensor-parallel SAM image encoder.

    Every rank of ``group`` (default: the world group) calls it with its own
    shard ``encoder`` (a :class:`~..models.sam.SamImageEncoder` built from
    :func:`shard_sam_encoder_tp` of one tree, the shard of its rank in the
    group) and the same normalised pixels ``pix`` (B, H, W, 3); all return
    the (B, gs, gs, out_c) embeddings. CPU tensors take every kernel's plain
    version, as everywhere in the port."""
    hook = TPGroup(dist.group.WORLD if group is None else group)
    check_tp(cfg, hook.size)
    if encoder.layers and encoder.layers[0].int8:
        raise ValueError("encoder_parallel does not compose with quant='int8' yet (the tp "
                         "encoder takes float weights): pick one")
    return encoder.neck(encoder.blocks(encoder.embed(pix), tp=hook))


__all__ = ["CopyToTP", "PARTIAL_GRAD_LEAVES", "PARTIAL_GRAD_LEAVES_GRID", "ReduceFromTP",
           "TPGroup", "check_tp", "sam_image_encoder_tp", "shard_layer", "shard_sam_encoder_tp",
           "unshard_layers"]
