"""Weight bridge: JAX-layout parameter trees -> the port's modules.

The trees are the JAX package's (numpy leaves): ``init_yolo_params`` /
``init_sam_params`` from either package, or trees converted from checkpoints
by the JAX package, including trees whose encoder projections were quantised
(``{"wq", "wscale", "b"}`` records, ``ops.quant.quantize_sam_encoder_params``
of either package), and MobileSAM trees, whose ``"tinyvit"`` subtree takes
the place of ``"vision"`` (``SamModel`` then builds TinyViT as its encoder).
Layout changes happen in the module constructors (conv weights HWIO -> OIHW);
linear weights keep the (in, out) layout.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .models.sam import SamModel, SamTPUConfig
from .models.yolo import YoloConfig, YoloV8


def from_jax_params(
    yolo_tree: Optional[Any],
    sam_tree: Optional[Any],
    device,
    dtype: torch.dtype = torch.float32,
    *,
    yolo_config: Optional[YoloConfig] = None,
    sam_config: Optional[SamTPUConfig] = None,
) -> Tuple[Optional[YoloV8], Optional[SamModel]]:
    """Build (YoloV8, SamModel) on ``device`` with floating weights in ``dtype``
    (cast once here, as the JAX engine casts outside its programs). int8
    weights and their fp32 scales keep their types. Either tree may be None;
    a SAM tree needs its ``sam_config`` (window sizes and heads are not in
    the tree)."""
    yolo = sam = None
    if yolo_tree is not None:
        yolo = YoloV8(yolo_tree, yolo_config or YoloConfig()).to(device=device, dtype=dtype)
    if sam_tree is not None:
        if sam_config is None:
            raise ValueError("from_jax_params: a SAM tree needs sam_config")
        sam = SamModel(sam_tree, sam_config).to(device=device)
        for name, p in sam.named_parameters():
            if p.is_floating_point() and not name.endswith(".wscale"):
                p.data = p.data.to(dtype)
    return yolo, sam
