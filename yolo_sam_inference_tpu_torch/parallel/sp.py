"""Sequence-parallel SAM image encoder over a ``torch.distributed`` group.

Counterpart of ``yolo_sam_inference_tpu/parallel/sp.py``, function for
function. The token grid's rows are split over the group's ranks, rank r
holding rows ``[r * S/sp, (r + 1) * S/sp)`` of every image:

* patch and positional embedding: each rank embeds its own pixel rows (the
  stride-``ps`` patch embedding has no halo) and adds its rows of
  ``pos_embed``. Every rank holds the whole batch and the same weights (built
  from one parameter tree), so nothing is scattered;
* windowed layers: windows are ``ws``-aligned row blocks, so with
  ``(S/sp) % ws == 0`` every window lies inside one rank. LN1 + qkv (K1),
  the row block's windows as a batch of ``ws x ws`` grids through the window
  attention (K2 + K3), or, at SAM's native window of 14 which that kernel
  does not take, through K12 at grid side 14 as the single-card flat route
  runs its windows (one rule on every device); the projection; no
  communication;
* global layers: q stays local; the k | v half of the qkv is all-gathered
  over the group in rank (= row) order, and K12 runs on the local q rows,
  its rel-pos terms taken at the rank's absolute first row;
* block tails (K4/K10), LayerNorms, residuals: token-local;
* neck: its 3x3 conv needs a one-row halo, so the grid is gathered once at
  the end and the neck runs on every rank.

Every rank returns the same ``(B, gs, gs, C)`` embeddings. Collectives:
``2 * len(global_attn_indexes) + 1`` all-gathers per batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import (
    K12_WINDOW,
    flash_attention_relpos,
    relpos_grid_attention,
    window_attention,
)
from ..ops.fused_ln import fused_ln_matmul, fused_ln_mlp, linear
from .comm import all_gather


def _win_part_rect(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, Hl, W, C) -> (B*nwh*nww, ws, ws, C); Hl and W must divide by ws.
    A rank's row block is a rectangle of the square grid."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // ws, ws, ww // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c)


def _win_unpart_rect(win: torch.Tensor, ws: int, b: int, hh: int, ww: int) -> torch.Tensor:
    c = win.shape[-1]
    x = win.reshape(b, hh // ws, ww // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hh, ww, c)


def _window_attention_local(layer, x, heads: int, ws: int):
    """A windowed layer's attention on a row block x (B, Hl, W, C), before
    LN1: LN1 + qkv, the windows as a batch of ws x ws grids through the
    window attention (K12 for windows of ``K12_WINDOW``), the projection.
    Every window is local."""
    b, hl, ww, _ = x.shape
    ln1 = layer.ln1
    qkv = fused_ln_matmul(x, ln1.scale, ln1.bias, layer.qkv.w, layer.qkv.b, eps=ln1.eps)
    win = _win_part_rect(qkv, ws).contiguous()
    if ws == K12_WINDOW:
        h = relpos_grid_attention(win, layer.rel_pos_h, layer.rel_pos_w, heads)
    else:
        h = window_attention(win, layer.rel_pos_h, layer.rel_pos_w, heads, ws)
    h = _win_unpart_rect(h, ws, b, hl, ww)
    return linear(h, layer.proj.w, layer.proj.b)


def _global_attention_sp(layer, x, s: int, group):
    """A global layer's attention on a row block x (B, Hl, S, C), before
    LN1: local q against the group's all-gathered k and v (one gather of the
    k | v half of the rank's qkv), K12 on the ``Hl * S`` local queries from
    the rank's absolute first row (``rank * Hl``), q, k and v read in place,
    the projection."""
    b, hl, ww, c = x.shape
    nl = hl * ww
    ln1 = layer.ln1
    qkv = fused_ln_matmul(x, ln1.scale, ln1.bias, layer.qkv.w, layer.qkv.b, eps=ln1.eps)
    qkv = qkv.reshape(b, nl, 3 * c)
    # (B, nl, 2C) from every rank -> (B, S*S, 2C): rank order is row order
    kv = all_gather(qkv[..., c:], group, dim=1)
    row0 = dist.get_rank(group) * hl
    o = flash_attention_relpos(qkv[..., :c], kv[..., :c], kv[..., c:], layer.rel_pos_h,
                               layer.rel_pos_w, s, row0=row0)
    return linear(o.reshape(b, hl, ww, c), layer.proj.w, layer.proj.b)


def _encoder_local(encoder, pix_local, row0: int, group):
    """One rank's row block through the encoder, then the gathered grid
    through the neck. ``pix_local`` holds the pixel rows of token rows
    ``[row0, row0 + S/sp)``."""
    cfg = encoder.cfg
    s, ws, heads = cfg.grid_size, cfg.window_size, cfg.vision_heads
    x = encoder.embed(pix_local, row0)
    for i, layer in enumerate(encoder.layers):
        if i in cfg.global_attn_indexes:
            h = _global_attention_sp(layer, x, s, group)
        else:
            h = _window_attention_local(layer, x, heads, ws)
        ln2 = layer.ln2
        x = fused_ln_mlp(x, h, ln2.scale, ln2.bias, layer.mlp1.w, layer.mlp1.b, layer.mlp2.w,
                         layer.mlp2.b, eps=ln2.eps)
    return encoder.neck(all_gather(x, group, dim=1))


def rows_per_rank(cfg, sp: int) -> int:
    """Token rows of each of ``sp`` ranks; raises as JAX ``sp.py:244-254``
    where the split does not fit the grid or its windows."""
    s, ws = cfg.grid_size, cfg.window_size
    if s % sp:
        raise ValueError(f"sp={sp} must divide grid_size={s}")
    rows_local = s // sp
    has_windowed = len(cfg.global_attn_indexes) < cfg.vision_layers
    if has_windowed and rows_local % ws:
        raise ValueError(f"sp={sp} leaves {rows_local} token rows per shard, not a "
                         f"multiple of window_size={ws}")
    return rows_local


def sam_image_encoder_sp(encoder, pix: torch.Tensor, cfg, group=None) -> torch.Tensor:
    """Sequence-parallel SAM image encoder.

    Every rank of ``group`` (default: the world group) calls it with the same
    ``encoder`` weights (a :class:`~..models.sam.SamImageEncoder` built from
    one tree) and the same normalised pixels ``pix`` (B, H, W, 3); each runs
    its own token rows and all return the (B, gs, gs, out_c) embeddings.
    CPU tensors take every kernel's plain version, as everywhere in the port.

    Requires ``grid_size % sp == 0`` and, when any windowed layer exists,
    ``(grid_size / sp) % window_size == 0`` (window-aligned row blocks).
    """
    if encoder.layers and encoder.layers[0].int8:
        raise ValueError("encoder_parallel does not compose with quant='int8' yet (the "
                         "sequence-parallel encoder takes float weights): pick one")
    group = dist.group.WORLD if group is None else group
    sp, rank = dist.get_world_size(group), dist.get_rank(group)
    rows_local = rows_per_rank(cfg, sp)
    ps = cfg.patch_size
    pix_local = pix[:, rank * rows_local * ps:(rank + 1) * rows_local * ps]
    return _encoder_local(encoder, pix_local, rank * rows_local, group)


__all__ = ["rows_per_rank", "sam_image_encoder_sp"]
