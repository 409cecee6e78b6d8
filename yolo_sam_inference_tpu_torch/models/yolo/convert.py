"""Convert ultralytics YOLOv8 checkpoints to the JAX-layout parameter tree.

Copy of ``yolo_sam_inference_tpu/models/yolo/convert.py`` (the port may not
import the JAX package). Operates on a plain ``name -> tensor`` state dict
with ultralytics module naming (``model.0.conv.weight``,
``model.22.cv2.0.0.conv.weight`` ...), the format of
``torch.save(model.model.state_dict())`` from a loaded ``ultralytics.YOLO``
checkpoint. BatchNorm is folded into the preceding conv at convert time; the
tree is host numpy with HWIO conv weights, the layout
``weights.from_jax_params`` takes.

Layer index map (YOLOv8 detect yaml):
  0 stem, 1 down2, 2 c2f2, 3 down3, 4 c2f3, 5 down4, 6 c2f4, 7 down5,
  8 c2f5, 9 sppf, 12 c2f_up4, 15 c2f_up3, 16 head.down4, 18 c2f_down4,
  19 head.down5, 21 c2f_down5, 22 detect.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping

import numpy as np

from ...utils.model_loader import torch_load
from .config import YoloConfig


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _fold_conv_bn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """ultralytics Conv = conv2d (no bias) + BN -> folded HWIO conv + bias."""
    w = _np(sd[f"{prefix}.conv.weight"])  # (O, I, kh, kw)
    gamma = _np(sd[f"{prefix}.bn.weight"])
    beta = _np(sd[f"{prefix}.bn.bias"])
    mean = _np(sd[f"{prefix}.bn.running_mean"])
    var = _np(sd[f"{prefix}.bn.running_var"])
    eps = 1e-3  # ultralytics BatchNorm2d eps
    scale = gamma / np.sqrt(var + eps)
    w_folded = w * scale[:, None, None, None]
    b_folded = beta - mean * scale
    return {"w": w_folded.transpose(2, 3, 1, 0).copy(), "b": b_folded}


def _plain_conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """Bare nn.Conv2d with bias (detect head final 1x1s)."""
    w = _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0).copy()
    return {"w": w, "b": _np(sd[f"{prefix}.bias"])}


def _c2f(sd: Mapping[str, Any], prefix: str, n: int) -> Dict[str, Any]:
    return {
        "cv1": _fold_conv_bn(sd, f"{prefix}.cv1"),
        "cv2": _fold_conv_bn(sd, f"{prefix}.cv2"),
        "m": [
            {
                "cv1": _fold_conv_bn(sd, f"{prefix}.m.{i}.cv1"),
                "cv2": _fold_conv_bn(sd, f"{prefix}.m.{i}.cv2"),
            }
            for i in range(n)
        ],
    }


def convert_ultralytics_state_dict(sd: Mapping[str, Any], cfg: YoloConfig) -> Dict[str, Any]:
    """Build the parameter tree from an ultralytics DetectionModel state dict."""
    if not any(k.startswith("model.") for k in sd):
        raise ValueError("expected ultralytics-style keys starting with 'model.'")

    n1 = cfg.depth(3)
    n2 = cfg.depth(6)

    backbone = {
        "stem": _fold_conv_bn(sd, "model.0"),
        "down2": _fold_conv_bn(sd, "model.1"),
        "c2f2": _c2f(sd, "model.2", n1),
        "down3": _fold_conv_bn(sd, "model.3"),
        "c2f3": _c2f(sd, "model.4", n2),
        "down4": _fold_conv_bn(sd, "model.5"),
        "c2f4": _c2f(sd, "model.6", n2),
        "down5": _fold_conv_bn(sd, "model.7"),
        "c2f5": _c2f(sd, "model.8", n1),
        "sppf": {
            "cv1": _fold_conv_bn(sd, "model.9.cv1"),
            "cv2": _fold_conv_bn(sd, "model.9.cv2"),
        },
    }
    head = {
        "c2f_up4": _c2f(sd, "model.12", n1),
        "c2f_up3": _c2f(sd, "model.15", n1),
        "down4": _fold_conv_bn(sd, "model.16"),
        "c2f_down4": _c2f(sd, "model.18", n1),
        "down5": _fold_conv_bn(sd, "model.19"),
        "c2f_down5": _c2f(sd, "model.21", n1),
    }
    detect = [
        {
            "box1": _fold_conv_bn(sd, f"model.22.cv2.{lvl}.0"),
            "box2": _fold_conv_bn(sd, f"model.22.cv2.{lvl}.1"),
            "box3": _plain_conv(sd, f"model.22.cv2.{lvl}.2"),
            "cls1": _fold_conv_bn(sd, f"model.22.cv3.{lvl}.0"),
            "cls2": _fold_conv_bn(sd, f"model.22.cv3.{lvl}.1"),
            "cls3": _plain_conv(sd, f"model.22.cv3.{lvl}.2"),
        }
        for lvl in range(3)
    ]
    return {"backbone": backbone, "head": head, "detect": detect}


def load_yolo_params(checkpoint_path: str, cfg: YoloConfig,
                     allow_pickle: bool = False) -> Dict[str, Any]:
    """Load a YOLO checkpoint and convert.

    Accepts (a) a plain state-dict file saved with
    ``torch.save(model.state_dict())`` or (b) a full ultralytics ``.pt``
    (which needs the ``ultralytics`` package to unpickle; export a state
    dict first where it is absent).

    Full ``.pt`` files need arbitrary unpickling (``weights_only=False``),
    which can execute code embedded in the checkpoint. That path is gated
    behind ``allow_pickle=True``: only pass it for checkpoints you trust.
    """
    try:
        obj = torch_load(checkpoint_path)
    except Exception as exc:
        if not allow_pickle:
            raise ValueError(
                f"{checkpoint_path} is not a plain state-dict checkpoint "
                f"(weights_only load failed: {exc}). If this is a trusted "
                "full ultralytics .pt, re-call with allow_pickle=True — "
                "unpickling untrusted checkpoints can execute arbitrary code."
            ) from exc
        logging.getLogger(__name__).warning(
            "load_yolo_params: falling back to full unpickling of %s "
            "(allow_pickle=True) — this executes code in the checkpoint; "
            "only do this for trusted files.",
            checkpoint_path,
        )
        obj = torch_load(checkpoint_path, weights_only=False)
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"], "state_dict"):
        sd = obj["model"].float().state_dict()
    elif isinstance(obj, dict) and all(hasattr(v, "shape") for v in obj.values()):
        sd = obj
    else:
        raise ValueError(f"unrecognized checkpoint format in {checkpoint_path}")
    return convert_ultralytics_state_dict(sd, cfg)
