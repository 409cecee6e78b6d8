"""Resolution adaptation of SAM parameter trees (host numpy).

Copy of ``adapt_resolution`` and ``_resize_linear_np`` from
``yolo_sam_inference_tpu/models/sam/convert.py``: the port may not import the
JAX package. Checkpoint conversion is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ...ops.preprocess import _linear_weights
from .config import SamTPUConfig


def _resize_linear_np(a: np.ndarray, out_len: int, axis: int) -> np.ndarray:
    """1-D linear resample along ``axis``, numerically matching
    ``jax.image.resize(method="linear")`` (the weights of
    ``ops.preprocess._linear_weights``)."""
    a = np.asarray(a)
    if a.shape[axis] == out_len:
        return a
    w = _linear_weights(a.shape[axis], out_len)
    out = np.tensordot(w, np.moveaxis(a, axis, 0).astype(np.float32), axes=(1, 0))
    return np.moveaxis(out, 0, axis).astype(a.dtype)


def adapt_resolution(params: Dict[str, Any], cfg_to: SamTPUConfig) -> Dict[str, Any]:
    """Adapt a SAM parameter tree to another encoder input resolution.

    * ``pos_embed`` (1, gs, gs, C): bilinear resize to the new grid;
    * global-attention ``rel_pos_h/w`` (2*gs-1, hd): linear interpolation;
    * windowed layers follow ``cfg_to.window_size`` (e.g. 16 instead of 14,
      which removes all window padding when the grid is a multiple of 16).
    """
    gs_to = cfg_to.grid_size
    params = dict(params)
    vision = dict(params["vision"])
    pos = np.asarray(vision["pos_embed"])
    if pos.shape[1] != gs_to:
        vision["pos_embed"] = _resize_linear_np(
            _resize_linear_np(pos, gs_to, axis=1), gs_to, axis=2
        )

    layers = []
    for i, lp in enumerate(vision["layers"]):
        size = gs_to if i in cfg_to.global_attn_indexes else cfg_to.window_size
        attn = lp["attn"]
        if np.asarray(attn["rel_pos_h"]).shape[0] != 2 * size - 1:
            attn = dict(attn)
            attn["rel_pos_h"] = _resize_linear_np(attn["rel_pos_h"], 2 * size - 1, axis=0)
            attn["rel_pos_w"] = _resize_linear_np(attn["rel_pos_w"], 2 * size - 1, axis=0)
            lp = dict(lp)
            lp["attn"] = attn
        layers.append(lp)
    vision["layers"] = layers
    params["vision"] = vision
    return params
