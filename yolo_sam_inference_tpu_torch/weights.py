"""Weight bridge: JAX-layout parameter trees -> the port's modules.

The trees are in the JAX package's layout (numpy leaves): ``init_yolo_params``
/ ``init_sam_params`` from either package, trees converted from checkpoint
files by either package's converters (the port's own are
``models/yolo/convert.py`` and ``models/sam/convert.py``), trees whose
encoder projections were quantised (``{"wq", "wscale", "b"}`` records,
``ops.quant.quantize_sam_encoder_params`` of either package), and MobileSAM
trees, whose ``"tinyvit"`` subtree takes the place of ``"vision"``
(``SamModel`` then builds TinyViT as its encoder). Layout changes happen
in the module constructors (conv weights HWIO -> OIHW for ``F.conv2d``;
with ``conv2d_fused`` the dense convs keep HWIO for ``conv2d_act``); linear
weights keep the (in, out) layout.

:func:`save_tree` and :func:`load_tree` carry a tree between processes (the
ranks of a multi-process run) as one uncompressed ``.npz``.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .models.sam import SamModel
from .models.yolo import YoloConfig, YoloV8


def from_jax_params(
    yolo_tree: Optional[Any],
    sam_tree: Optional[Any],
    device,
    dtype: torch.dtype = torch.float32,
    *,
    yolo_config: Optional[YoloConfig] = None,
    sam_config: Optional[Any] = None,
    conv2d_fused: bool = False,
    tinyvit_mbconv_compute: str = "fp32",
) -> Tuple[Optional[YoloV8], Optional[SamModel]]:
    """Build (YoloV8, SamModel) on ``device`` with floating weights in ``dtype``
    (cast once here, as the JAX engine casts outside its programs). int8
    weights and their fp32 scales keep their types. Either tree may be None;
    a SAM tree needs its ``sam_config`` (window sizes and heads are not in
    the tree). ``conv2d_fused`` puts the dense convs of both models on
    ``conv2d_act`` (K17); ``tinyvit_mbconv_compute`` is a MobileSAM
    encoder's K14/K15 compute mode. The configuration builds its family's
    model (``build``): a SAM 2 configuration ``Sam2Model``, from a tree in
    ``models/sam/hiera.py``'s layout."""
    yolo = sam = None
    if yolo_tree is not None:
        yolo = YoloV8(yolo_tree, yolo_config or YoloConfig(), conv2d_fused)
        yolo = yolo.to(device=device, dtype=dtype)
    if sam_tree is not None:
        if sam_config is None:
            raise ValueError("from_jax_params: a SAM tree needs sam_config")
        sam = sam_config.build(sam_tree, conv2d_fused=conv2d_fused,
                               tinyvit_mbconv_compute=tinyvit_mbconv_compute).to(device=device)
        for name, p in sam.named_parameters():
            if p.is_floating_point() and not name.endswith(".wscale"):
                p.data = p.data.to(dtype)
            # converted leaves may be strided views (a folded conv's transpose);
            # the kernels take contiguous weights
            p.data = p.data.contiguous()
    return yolo, sam


def save_tree(path, tree) -> None:
    """Write a parameter tree (nested dicts and lists of arrays, None leaves)
    to ``path`` (.npz): the arrays as entries, the nesting as JSON."""
    leaves = []

    def skeleton(t):
        if isinstance(t, dict):
            return {k: skeleton(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [skeleton(v) for v in t]
        if t is None:
            return None
        leaves.append(np.asarray(t))
        return len(leaves) - 1

    nest = json.dumps(skeleton(tree))
    np.savez(path, __tree__=np.array(nest), **{f"a{i}": a for i, a in enumerate(leaves)})


def load_tree(path):
    """The tree :func:`save_tree` wrote (tuples come back as lists)."""
    with np.load(path) as z:
        def build(t):
            if isinstance(t, dict):
                return {k: build(v) for k, v in t.items()}
            if isinstance(t, list):
                return [build(v) for v in t]
            return None if t is None else z[f"a{t}"]

        return build(json.loads(str(z["__tree__"])))
