"""SAM fine-tuning step (dp x tp) on the port.

Counterpart of ``make_train_state`` / ``sam_decoder_train_step`` /
``_loss_fn`` of ``yolo_sam_inference_tpu/parallel/train.py``: box -> mask
supervision of the whole SAM tree.

* **Loss**, per box: sigmoid BCE of the low-res mask logits (mask 0, as
  ``multimask_output=False``) averaged over pixels, plus 0.1 x the squared
  error between the IoU head and the detached IoU of the thresholded mask
  with its target; weighted by ``valid`` and divided by the count of valid
  boxes.
* **Optimiser**: ``torch.optim.AdamW`` with optax's ``adamw`` defaults (b1
  0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every parameter). A leaf the
  loss does not reach gets a zero gradient, so its weight still decays, as
  optax decays it.
* **Weights**: fp32 masters in the JAX layout, keyed by their ``"::"`` paths
  (``utils/checkpoint.py``). A forward casts them to the compute dtype (bf16
  on the card) inside the graph and runs ``SamModel`` over the casts
  (``torch.func.functional_call``): on the card every kernel of the forward
  goes through ``ops/autograd.py``, its backward the plain version's
  autograd in fp32.
* **dp**: each rank of the mesh's data axis takes its share of the batch;
  the loss is divided by the global count of valid boxes (all-reduced
  before the backward), and the gradients are summed over dp.
* **tp**: the encoder runs through ``parallel/tp.py`` (each rank keeps its
  shard). A split leaf's gradient is its rank's own. A replicated leaf that
  a rank applies to its own heads or columns alone (``tp.
  PARTIAL_GRAD_LEAVES``: the rel-pos tables, and on the grid route the
  LayerNorms) has only its share there, so that gradient is summed over tp;
  every other replicated gradient is whole on each tp rank and averaged over
  them. The replicated parameters stay equal on the tp ranks.

int8 weights and TinyViT raise, as the JAX step cannot take them either.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.sam import SamModel, init_sam_params, is_tinyvit
from ..ops.quant import is_quantized
from ..utils.checkpoint import flatten_tree, unflatten_like
from .comm import all_reduce_sum
from .mesh import data_shard
from .tp import (
    PARTIAL_GRAD_LEAVES,
    PARTIAL_GRAD_LEAVES_GRID,
    sam_image_encoder_tp,
    shard_sam_encoder_tp,
    unshard_layers,
)

# optax.adamw's defaults (torch.optim.AdamW's weight decay is 1e-2)
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
# the vision-layer leaves parallel/tp.py splits over the tp ranks
TP_SHARDED = ("attn::qkv::w", "attn::qkv::b", "attn::proj::w", "mlp1::w", "mlp1::b", "mlp2::w")


def module_name(key: str) -> Optional[str]:
    """The ``SamModel`` parameter of a JAX tree key (None for a leaf the
    model does not hold)."""
    parts = key.split("::")
    head, rest = parts[0], parts[1:]
    if key in ("shared_pe", "shared_image_pe"):
        return f"prompt.{key}"
    if head == "prompt":
        return f"prompt.{rest[0]}" if rest[0] in ("point_embed", "not_a_point", "no_mask") else None
    if head == "decoder":
        return ".".join("inp" if p == "in" else p for p in parts)
    if head == "vision":
        if rest[0] == "layers":
            return ".".join(["vision", "layers", rest[1], *(p for p in rest[2:] if p != "attn")])
        fixed = {"patch_embed::w": "patch_w", "patch_embed::b": "patch_b", "pos_embed": "pos_embed",
                 "neck::conv1_w": "neck_conv1", "neck::conv2_w": "neck_conv2"}
        tail = "::".join(rest)
        if tail in fixed:
            return f"vision.{fixed[tail]}"
        if rest[0] == "neck":
            return f"vision.neck_{rest[1]}.{rest[2]}"
    raise ValueError(f"no SamModel parameter for tree key {key!r}")


def _module_form(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """A JAX-layout leaf in its module's layout (differentiable): the neck's
    3x3 HWIO -> OIHW, the patch embedding (ps, ps, 3, C) -> (ps ps 3, C)."""
    if name == "vision.neck_conv2":
        return t.permute(3, 2, 0, 1)
    return t.reshape(shape)


def _refuse(tree) -> None:
    if is_tinyvit(tree):
        raise ValueError("the SAM fine-tune step takes ViT encoders only (TinyViT's tree has no "
                         "train step, as in the JAX package)")
    lp = tree["vision"]["layers"][0] if tree["vision"]["layers"] else {}
    if lp and (is_quantized(lp["attn"]["qkv"]) or is_quantized(lp["mlp1"])):
        raise ValueError("the SAM fine-tune step takes float weights, not quant='int8' ones")


def _mesh_axes(mesh):
    """(dp, dp group, tp, tp index, tp group, the mesh's group)."""
    if mesh is None:
        return 1, None, 1, 0, None, None
    shape = mesh.shape
    dp, tp = shape.get("dp", 1), shape.get("tp", 1)
    return (dp, mesh.axis_group("dp") if dp > 1 else None, tp,
            mesh.index("tp") if tp > 1 else 0, mesh.axis_group("tp") if tp > 1 else None,
            mesh.group)


def make_train_state(rng, cfg, mesh=None, learning_rate: float = 1e-4, *, params=None,
                     device="cuda") -> dict:
    """Parameters (``init_sam_params(rng, cfg)``, or the tree ``params``; the
    rank's tp shard under a mesh with a 'tp' axis) as fp32 masters on
    ``device``, and the optimiser. The forward computes in bf16 on a CUDA
    device (the kernels' dtype), in fp32 on the CPU (the JAX step's)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_state(device='cuda'): no CUDA device")
    tree = init_sam_params(rng, cfg) if params is None else params
    _refuse(tree)
    _, _, tp, index, _, _ = _mesh_axes(mesh)
    if tp > 1:
        tree = shard_sam_encoder_tp(tree, cfg, tp, index)
    flat = flatten_tree(tree)
    masters = {key: torch.nn.Parameter(torch.tensor(np.asarray(leaf, np.float32), device=device))
               for key, leaf in flat.items()}
    model = SamModel(tree, cfg)  # the template functional_call runs over (host memory)
    names = {key: module_name(key) for key in masters}
    shapes = dict(model.named_parameters())
    missing = set(shapes) - set(names.values())
    if missing:
        raise ValueError(f"SamModel parameters without a tree leaf: {sorted(missing)}")
    names = {k: (n, shapes[n].shape) for k, n in names.items() if n is not None}
    opt = torch.optim.AdamW(masters.values(), lr=learning_rate, **ADAMW)
    compute_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return {"params": masters, "opt_state": opt, "step": 0, "mesh": mesh, "device": device,
            "compute_dtype": compute_dtype, "_model": model, "_names": names, "_like": tree}


def forward(state, images, boxes, cfg, plain: bool = False):
    """(mask-0 logits (B, K, 4gs, 4gs) fp32, IoU head (B, K)) of the state's
    model on ``images`` (B, H, W, 3) normalised and ``boxes`` (B, K, 4) in
    encoder-input pixels. The masters and the images are cast to the compute
    dtype in the graph. ``plain`` is the oracle: the same cast values, run in
    fp32 through the kernels' plain versions (a model of fp32 masters would
    move the positional encodings by radians: the Fourier matrix's entries
    are O(100) and bf16 rounds them)."""
    model = state["_model"]
    cd = state["compute_dtype"]
    dt = torch.float32 if plain else cd
    weights = {name: _module_form(name, state["params"][key], shape).to(cd).to(dt)
               for key, (name, shape) in state["_names"].items()}
    _, _, tp, _, tp_group, _ = _mesh_axes(state["mesh"])

    def encode(pix):
        if tp > 1:
            return sam_image_encoder_tp(model.vision, pix, cfg, tp_group)
        return model.vision(pix, plain)

    logits, iou = torch.func.functional_call(
        model, weights, (images.to(cd).to(dt), boxes), {"plain": plain, "encode": encode},
        strict=False)
    return logits[:, :, 0], iou[..., 0].float()


def loss_terms(logits, iou_pred, masks, valid):
    """Per-box BCE + 0.1 x IoU squared error, weighted by ``valid``: (the
    weighted sum, the valid count). JAX ``train.py:87-96``."""
    targets = masks.float()
    bce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none").mean((-2, -1))
    pred_bin = (logits > 0).float()
    inter = (pred_bin * targets).sum((-2, -1))
    union = (pred_bin + targets - pred_bin * targets).sum((-2, -1)).clamp(min=1.0)
    iou_mse = (iou_pred - (inter / union).detach()) ** 2
    valid = valid.float()
    return ((bce + 0.1 * iou_mse) * valid).sum(), valid.sum()


def _local_batch(state, batch):
    """This rank's share of the batch on the state's device."""
    mesh = state["mesh"]
    out = {}
    for key in ("images", "boxes", "masks", "valid"):
        v = batch[key]
        if mesh is not None and mesh.shape.get("dp", 1) > 1:
            v = v[data_shard(mesh, v.shape[0])]
        out[key] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(
            state["device"])
    return out


def tp_kind(state, key: str) -> str:
    """How tp holds a leaf's gradient: ``"sharded"`` (the rank's shard),
    ``"partial"`` (a replicated leaf, the rank's share of its gradient) or
    ``"whole"`` (a replicated leaf, its whole gradient on every rank)."""
    if key.startswith("vision::layers::"):
        if key.endswith(TP_SHARDED):
            return "sharded"
        grid = state["_model"].vision.grid_route()
        if key.endswith(PARTIAL_GRAD_LEAVES_GRID if grid else PARTIAL_GRAD_LEAVES):
            return "partial"
    return "whole"


def _reduce_grads(state) -> None:
    """Sum the gradients over dp; over tp too the replicated ones that each
    tp rank holds a share of, and average over tp the whole ones
    (:func:`tp_kind`). One flat fp32 all-reduce per group."""
    dp, dp_group, tp, _, _, group = _mesh_axes(state["mesh"])
    if dp == 1 and tp == 1:
        return
    kinds = {k: tp_kind(state, k) if tp > 1 else "whole" for k in state["params"]}
    scale = {"partial": 1.0, "whole": 1.0 / tp}
    replicated = [(p, scale[kinds[k]]) for k, p in state["params"].items()
                  if kinds[k] != "sharded"]
    sharded = [(p, 1.0) for k, p in state["params"].items() if kinds[k] == "sharded"]
    for params, grp in ((replicated, group), (sharded, dp_group)):
        if not params or grp is None:
            continue
        flat = torch.cat([p.grad.reshape(-1).float() * s for p, s in params])
        total = all_reduce_sum(flat, grp)
        off = 0
        for p, _ in params:
            n = p.numel()
            p.grad.copy_(total[off:off + n].view_as(p))
            off += n


def sam_decoder_train_step(state, batch, cfg, mesh=None,
                           timings: Optional[Dict[str, float]] = None):
    """One dp x tp step. ``batch``: images (B, H, W, 3) fp32 normalised,
    boxes (B, K, 4), masks (B, K, l, l), valid (B, K), numpy or torch, the
    whole batch on every rank (each takes its share). Returns
    ``(state, loss)``, the loss of the whole batch as a float. ``timings``
    accumulates the seconds of the step's parts (``forward``, ``backward``,
    ``update``: the gradient reduction and the optimiser), the device
    synchronised after each."""
    if mesh is not None and mesh is not state["mesh"]:
        raise ValueError("sam_decoder_train_step: the state was made for another mesh")
    dp, dp_group, _, _, _, _ = _mesh_axes(state["mesh"])
    clock = _Clock(state["device"], timings)
    local = _local_batch(state, batch)
    count = local["valid"].float().sum()
    if dp > 1:
        count = all_reduce_sum(count, dp_group)
    opt = state["opt_state"]
    opt.zero_grad(set_to_none=True)
    logits, iou = forward(state, local["images"], local["boxes"], cfg)
    total, _ = loss_terms(logits, iou, local["masks"], local["valid"])
    loss = total / count.clamp(min=1.0).to(total.device)
    clock.lap("forward")
    loss.backward()
    clock.lap("backward")
    for p in state["params"].values():
        if p.grad is None:  # a leaf the loss does not reach: optax still decays it
            p.grad = torch.zeros_like(p)
    _reduce_grads(state)
    opt.step()
    value = loss.detach().float()
    if dp > 1:
        value = all_reduce_sum(value, dp_group)
    clock.lap("update")
    state["step"] += 1
    return state, float(value)


class _Clock:
    """Seconds between laps into ``timings`` (the device synchronised at
    each); nothing where ``timings`` is None."""

    def __init__(self, device, timings):
        self.device, self.timings = device, timings
        self.t = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, key: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[key] = self.timings.get(key, 0.0) + now - self.t
        self.t = now


def gather_params(state, grads: bool = False):
    """The state's parameters (with ``grads``, their gradients of the last
    step, as reduced over the mesh) as one whole tree in the JAX layout
    (numpy fp32): under tp the ranks' shards are gathered over the tp group
    and joined (a collective: every rank of the group calls it)."""
    flat = {k: (p.grad if grads else p).detach().float().cpu().numpy()
            for k, p in state["params"].items()}
    tree = unflatten_like(flat, state["_like"])
    _, _, tp, _, tp_group, _ = _mesh_axes(state["mesh"])
    if tp == 1:
        return tree
    cfg = state["_model"].cfg
    shards = [None] * tp
    dist.all_gather_object(shards, tree["vision"]["layers"], group=tp_group)
    layers = [unshard_layers([s[i] for s in shards], cfg) for i in range(len(shards[0]))]
    return {**tree, "vision": {**tree["vision"], "layers": layers}}


__all__ = ["ADAMW", "forward", "gather_params", "loss_terms", "make_train_state",
           "module_name", "sam_decoder_train_step", "tp_kind"]
