"""Pipeline-parallel SAM image encoder over a ``torch.distributed`` group.

Counterpart of ``yolo_sam_inference_tpu/parallel/pp.py``: the encoder's
layers are split into ``pp`` contiguous stages, stage d (the group's rank d)
holding layers ``[d L/pp, (d + 1) L/pp)`` and no other
(:func:`stage_tree`), and microbatches flow through the stages GPipe-style
(``M + pp - 1`` steps, ``M`` microbatches, default ``pp``):

* at step t stage d runs microbatch ``t - d`` where there is one: stage 0
  embeds it (patch and positional embedding, on every stage's weights but
  run by stage 0 alone), the others receive it from stage d - 1; its layers
  run on the port's ``VisionLayer`` (the kernels), and it sends the result
  to stage d + 1 (on gloo through pinned host buffers, :mod:`.comm`);
* on the flat route a stage hands on ``x + pending``: the MLP residual that
  the single-card route carries into the next layer's LayerNorm is added at
  the boundary (``SamImageEncoder.blocks``);
* the last stage joins the microbatches, runs the neck and broadcasts the
  embeddings, so every rank returns the whole ``(B, gs, gs, out_c)``.

The bubble is ``(pp - 1) / (M + pp - 1)`` of the steps.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .comm import broadcast, recv, send

Params = Dict[str, Any]


def stage_range(cfg, pp: int, stage: int) -> range:
    """The model layers of ``stage``; raises as JAX ``pp.py:137-139`` where
    ``pp`` does not divide the layers."""
    nl = cfg.vision_layers
    if nl % pp:
        raise ValueError(f"pp={pp} must divide vision_layers={nl}")
    per = nl // pp
    return range(stage * per, (stage + 1) * per)


def stage_tree(params: Params, cfg, pp: int, stage: int) -> Params:
    """The SAM tree with its ``"vision"`` layers cut to those of ``stage``
    (the embeddings and the neck whole)."""
    v = params["vision"]
    vision = {k: val for k, val in v.items() if k != "layers"}
    vision["layers"] = [v["layers"][i] for i in stage_range(cfg, pp, stage)]
    return {**params, "vision": vision}


def sam_image_encoder_pp(encoder, pix: torch.Tensor, cfg, group=None,
                         microbatches: Optional[int] = None) -> torch.Tensor:
    """Pipeline-parallel SAM image encoder.

    Every rank of ``group`` (default: the world group; its size is ``pp``)
    calls it with its stage's encoder (a :class:`~..models.sam.
    SamImageEncoder` built from :func:`stage_tree` of one tree for its rank)
    and the same normalised pixels ``pix`` (B, H, W, 3). Requires
    ``vision_layers % pp == 0`` and ``B % microbatches == 0``
    (``microbatches`` defaults to ``pp``). Returns (B, gs, gs, out_c) on
    every rank. CPU tensors take every kernel's plain version."""
    group = dist.group.WORLD if group is None else group
    pp, stage = dist.get_world_size(group), dist.get_rank(group)
    layers = stage_range(cfg, pp, stage)
    if len(encoder.layers) != len(layers):
        raise ValueError(f"stage {stage} of {pp} holds {len(encoder.layers)} layers, expected "
                         f"{len(layers)} (build it from stage_tree)")
    b = pix.shape[0]
    m = int(microbatches) if microbatches else pp
    if b % m:
        raise ValueError(f"microbatches={m} must divide batch={b}")
    mb = b // m
    s, c = cfg.grid_size, cfg.vision_hidden
    shape, dtype = (mb, s, s, c), pix.dtype
    outs = []
    for t in range(m + pp - 1):
        i = t - stage
        if not 0 <= i < m:
            continue
        if stage == 0:
            x = encoder.embed(pix[i * mb:(i + 1) * mb])
        else:
            x = recv(shape, dtype, pix.device, stage - 1, group)
        x = encoder.blocks(x, first=layers.start)
        if stage < pp - 1:
            send(x, stage + 1, group)
        else:
            outs.append(x)
    oc = cfg.output_channels
    if stage == pp - 1:
        emb = encoder.neck(torch.cat(outs))
    else:
        emb = torch.empty((b, s, s, oc), dtype=dtype, device=pix.device)
    return broadcast(emb, pp - 1, group)


__all__ = ["sam_image_encoder_pp", "stage_range", "stage_tree"]
