"""Convert SAM checkpoints to the JAX-layout parameter tree, and adapt
trees to another encoder resolution (host numpy).

Copy of ``yolo_sam_inference_tpu/models/sam/convert.py`` (the port may not
import the JAX package):

* :func:`convert_hf_sam_state_dict` maps the ``transformers`` ``SamModel``
  naming (``facebook/sam-vit-base/large/huge``) onto the tree of
  ``model.init_sam_params``;
* :func:`convert_mobilesam_state_dict` maps the official MobileSAM
  checkpoint (``mobile_sam.pt``: TinyViT ``image_encoder.*`` with
  Conv2d_BN pairs, the prompt encoder and decoder in the original
  segment-anything naming) onto a tree with a ``"tinyvit"`` subtree;
* :func:`load_sam_params` reads a ``.safetensors`` or torch ``.bin``/``.pt``
  file and converts it, adapting a ViT tree from the checkpoints' native
  1024 canvas;
* :func:`adapt_resolution` resizes the positional embedding and the rel-pos
  tables to another canvas and window.

Any mapping of name -> array is accepted (a torch state dict, a safetensors
dict, a numpy dict).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from ...ops.preprocess import _linear_weights
from ...ops.tinyvit_attention import offset_index
from ...utils.model_loader import torch_load
from .config import SamTPUConfig
from .tinyvit import TinyViTConfig


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _lin(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch Linear (out, in) -> ours (in, out)."""
    return {
        "w": _np(sd[f"{prefix}.weight"]).T.copy(),
        "b": _np(sd[f"{prefix}.bias"]),
    }


def _ln(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def convert_hf_sam_state_dict(
    sd: Mapping[str, Any], cfg: SamTPUConfig
) -> Dict[str, Any]:
    """Build our parameter pytree from a HF SamModel state dict."""

    def vis_layer(i: int) -> Dict[str, Any]:
        p = f"vision_encoder.layers.{i}"
        return {
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "attn": {
                "qkv": _lin(sd, f"{p}.attn.qkv"),
                "proj": _lin(sd, f"{p}.attn.proj"),
                "rel_pos_h": _np(sd[f"{p}.attn.rel_pos_h"]),
                "rel_pos_w": _np(sd[f"{p}.attn.rel_pos_w"]),
            },
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "mlp1": _lin(sd, f"{p}.mlp.lin1"),
            "mlp2": _lin(sd, f"{p}.mlp.lin2"),
        }

    vision = {
        "patch_embed": {
            # torch conv (C, 3, ps, ps) -> HWIO (ps, ps, 3, C)
            "w": _np(sd["vision_encoder.patch_embed.projection.weight"]).transpose(2, 3, 1, 0),
            "b": _np(sd["vision_encoder.patch_embed.projection.bias"]),
        },
        "pos_embed": _np(sd["vision_encoder.pos_embed"]),
        "layers": [vis_layer(i) for i in range(cfg.vision_layers)],
        "neck": {
            # 1x1 conv (oc, c, 1, 1) -> (c, oc)
            "conv1_w": _np(sd["vision_encoder.neck.conv1.weight"])[:, :, 0, 0].T.copy(),
            "ln1": _ln(sd, "vision_encoder.neck.layer_norm1"),
            # 3x3 conv (oc, oc, 3, 3) -> HWIO
            "conv2_w": _np(sd["vision_encoder.neck.conv2.weight"]).transpose(2, 3, 1, 0),
            "ln2": _ln(sd, "vision_encoder.neck.layer_norm2"),
        },
    }

    prompt = {
        "point_embed": np.stack(
            [_np(sd[f"prompt_encoder.point_embed.{i}.weight"])[0] for i in range(4)]
        ),
        "not_a_point": _np(sd["prompt_encoder.not_a_point_embed.weight"])[0],
        "no_mask": _np(sd["prompt_encoder.no_mask_embed.weight"])[0],
        "mask_embed": None,
    }

    def dec_attn(prefix: str) -> Dict[str, Any]:
        return {
            "q": _lin(sd, f"{prefix}.q_proj"),
            "k": _lin(sd, f"{prefix}.k_proj"),
            "v": _lin(sd, f"{prefix}.v_proj"),
            "out": _lin(sd, f"{prefix}.out_proj"),
        }

    def dec_layer(i: int) -> Dict[str, Any]:
        p = f"mask_decoder.transformer.layers.{i}"
        return {
            "self_attn": dec_attn(f"{p}.self_attn"),
            "ln1": _ln(sd, f"{p}.layer_norm1"),
            "t2i": dec_attn(f"{p}.cross_attn_token_to_image"),
            "ln2": _ln(sd, f"{p}.layer_norm2"),
            "mlp1": _lin(sd, f"{p}.mlp.lin1"),
            "mlp2": _lin(sd, f"{p}.mlp.lin2"),
            "ln3": _ln(sd, f"{p}.layer_norm3"),
            "i2t": dec_attn(f"{p}.cross_attn_image_to_token"),
            "ln4": _ln(sd, f"{p}.layer_norm4"),
        }

    def ff(prefix: str, depth: int) -> Dict[str, Any]:
        return {
            "in": _lin(sd, f"{prefix}.proj_in"),
            "hidden": [_lin(sd, f"{prefix}.layers.{i}") for i in range(depth - 2)],
            "out": _lin(sd, f"{prefix}.proj_out"),
        }

    decoder = {
        "iou_token": _np(sd["mask_decoder.iou_token.weight"]),
        "mask_tokens": _np(sd["mask_decoder.mask_tokens.weight"]),
        "layers": [dec_layer(i) for i in range(cfg.decoder_layers)],
        "final_t2i": dec_attn("mask_decoder.transformer.final_attn_token_to_image"),
        "ln_final": _ln(sd, "mask_decoder.transformer.layer_norm_final_attn"),
        # ConvTranspose2d weights are already (in, out, kh, kw) — our layout
        "up1_w": _np(sd["mask_decoder.upscale_conv1.weight"]),
        "up1_b": _np(sd["mask_decoder.upscale_conv1.bias"]),
        "up_ln": _ln(sd, "mask_decoder.upscale_layer_norm"),
        "up2_w": _np(sd["mask_decoder.upscale_conv2.weight"]),
        "up2_b": _np(sd["mask_decoder.upscale_conv2.bias"]),
        "hyper_mlps": [
            ff(f"mask_decoder.output_hypernetworks_mlps.{i}", 3)
            for i in range(cfg.num_mask_tokens)
        ],
        "iou_head": ff("mask_decoder.iou_prediction_head", cfg.iou_head_depth),
    }

    # Two Fourier matrices exist in the HF graph: the model-level
    # shared_image_embedding (image-wide dense PE) and the prompt encoder's
    # shared_embedding (point/box PE). Pretrained checkpoints tie them; random
    # torch inits do not, so we carry both.
    return {
        "vision": vision,
        "prompt": prompt,
        "decoder": decoder,
        "shared_pe": _np(sd["prompt_encoder.shared_embedding.positional_embedding"]),
        "shared_image_pe": _np(sd["shared_image_embedding.positional_embedding"]),
    }


# --------------------------------------------------------------- MobileSAM
#
# The official MobileSAM checkpoint (mobile_sam.pt, ChaoningZhang/MobileSAM)
# is a full-SAM state dict: ``image_encoder.*`` in TinyViT naming
# (Conv2d_BN = conv 'c' + batchnorm 'bn' pairs) and ``prompt_encoder.*`` /
# ``mask_decoder.*`` in the original segment-anything naming (norm1..norm4,
# output_upscaling.{0,1,3}, layers.{0,1,2} MLPs) rather than HF's. The
# reference swaps SAM variants purely by checkpoint name
# (reference pipeline.py:76); loading real MobileSAM weights needs this
# mapping.


def _fold_conv_bn(sd: Mapping[str, Any], prefix: str,
                  eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """TinyViT Conv2d_BN -> folded conv. torch (O, I/g, kh, kw) -> HWIO."""
    w = _np(sd[f"{prefix}.c.weight"]).astype(np.float64)
    g = _np(sd[f"{prefix}.bn.weight"]).astype(np.float64)
    b = _np(sd[f"{prefix}.bn.bias"]).astype(np.float64)
    rm = _np(sd[f"{prefix}.bn.running_mean"]).astype(np.float64)
    rv = _np(sd[f"{prefix}.bn.running_var"]).astype(np.float64)
    s = g / np.sqrt(rv + eps)
    wf = (w * s[:, None, None, None]).transpose(2, 3, 1, 0)
    return {"w": wf.astype(np.float32), "b": (b - rm * s).astype(np.float32)}


def _qkv_perm(heads: int, hd: int) -> np.ndarray:
    """TinyViT qkv output features are per-head [q, k, v] interleaved
    (Attention.forward splits view(B, N, heads, 3*hd)); ours are three
    contiguous q/k/v blocks. Returns the torch-row index for each of our
    output features."""
    idx = np.arange(3 * heads * hd).reshape(heads, 3, hd)
    return idx.transpose(1, 0, 2).reshape(-1)


def abs_offset_index(ws: int) -> np.ndarray:
    """(T, T) column of each token pair's bias in the official TinyViT
    ``attention_biases`` table: offsets (|dr|, |dc|) numbered in the order
    the official ``Attention.__init__`` first meets them, walking the query
    and key points of the ws x ws window in raster order. This is what its
    ``attention_bias_idxs`` buffer holds."""
    coords = np.stack(np.mgrid[:ws, :ws], -1).reshape(-1, 2)
    rel = np.abs(coords[:, None, :] - coords[None, :, :])
    key = rel[..., 0] * ws + rel[..., 1]
    _, first, inverse = np.unique(key.reshape(-1), return_index=True, return_inverse=True)
    order = np.argsort(np.argsort(first))  # rank of each offset by first sight
    return order[inverse].reshape(key.shape)


def convert_mobilesam_tinyvit(
    sd: Mapping[str, Any], tcfg, prefix: str = "image_encoder."
) -> Dict[str, Any]:
    """Map TinyViT-5M ``image_encoder.*`` keys onto our tinyvit tree.

    The official code registers ``attention_bias_idxs`` with
    ``persistent=False``, so a checkpoint may lack it: the index is then
    rebuilt from the window size (:func:`abs_offset_index`); where the key
    is present it is read."""
    def fold(name):
        return _fold_conv_bn(sd, prefix + name)

    def merge(name):
        return {"conv1": fold(f"{name}.conv1"), "conv2": fold(f"{name}.conv2"),
                "conv3": fold(f"{name}.conv3")}

    def block(si: int, i: int, heads: int, ws: int) -> Dict[str, Any]:
        p = f"{prefix}layers.{si}.blocks.{i}"
        c = tcfg.embed_dims[si]
        hd = c // heads
        perm = _qkv_perm(heads, hd)
        qkv_w = _np(sd[f"{p}.attn.qkv.weight"])[perm].T.copy()  # (C, 3C)
        qkv_b = _np(sd[f"{p}.attn.qkv.bias"])[perm]
        # the checkpoint's attention_biases columns follow the original
        # dict-insertion offset ordering; its attention_bias_idxs buffer maps
        # (query, key) -> column, so scatter into our raster offset layout
        theirs = _np(sd[f"{p}.attn.attention_biases"])
        idx_key = f"{p}.attn.attention_bias_idxs"
        their_idx = (_np(sd[idx_key]).astype(np.int64) if idx_key in sd
                     else abs_offset_index(ws))
        our_idx = offset_index(ws)
        bias = np.zeros((heads, (2 * ws - 1) ** 2), np.float32)
        bias[:, our_idx.reshape(-1)] = theirs[:, their_idx.reshape(-1)]
        return {
            "ln1": _ln(sd, f"{p}.attn.norm"),
            "attn": {
                "qkv_w": qkv_w, "qkv_b": qkv_b,
                "proj_w": _np(sd[f"{p}.attn.proj.weight"]).T.copy(),
                "proj_b": _np(sd[f"{p}.attn.proj.bias"]),
                "attn_bias": bias,
            },
            "local_conv": fold(f"layers.{si}.blocks.{i}.local_conv"),
            "ln2": _ln(sd, f"{p}.mlp.norm"),
            "mlp1_w": _np(sd[f"{p}.mlp.fc1.weight"]).T.copy(),
            "mlp1_b": _np(sd[f"{p}.mlp.fc1.bias"]),
            "mlp2_w": _np(sd[f"{p}.mlp.fc2.weight"]).T.copy(),
            "mlp2_b": _np(sd[f"{p}.mlp.fc2.bias"]),
        }

    return {
        "stem1": fold("patch_embed.seq.0"),
        "stem2": fold("patch_embed.seq.2"),
        "stage0": [merge(f"layers.0.blocks.{i}")
                   for i in range(tcfg.depths[0])],
        "merge0": merge("layers.0.downsample"),
        **{f"stage{si}": [
            block(si, i, tcfg.num_heads[si], tcfg.window_sizes[si])
            for i in range(tcfg.depths[si])
        ] for si in (1, 2, 3)},
        "merge1": merge("layers.1.downsample"),
        "merge2": merge("layers.2.downsample"),
        "neck": {
            "conv1_w": _np(sd[f"{prefix}neck.0.weight"])[:, :, 0, 0].T.copy(),
            "ln1": _ln(sd, f"{prefix}neck.1"),
            "conv2_w": _np(sd[f"{prefix}neck.2.weight"]).transpose(2, 3, 1, 0),
            "ln2": _ln(sd, f"{prefix}neck.3"),
        },
    }


def convert_mobilesam_state_dict(
    sd: Mapping[str, Any], cfg: SamTPUConfig, tcfg=None
) -> Dict[str, Any]:
    """Full MobileSAM checkpoint -> our pytree: TinyViT encoder under
    ``tinyvit``, prompt/decoder from the original segment-anything naming."""
    tcfg = tcfg or TinyViTConfig(image_size=cfg.image_size,
                                 output_channels=cfg.output_channels)

    prompt = {
        "point_embed": np.stack(
            [_np(sd[f"prompt_encoder.point_embeddings.{i}.weight"])[0]
             for i in range(4)]
        ),
        "not_a_point": _np(sd["prompt_encoder.not_a_point_embed.weight"])[0],
        "no_mask": _np(sd["prompt_encoder.no_mask_embed.weight"])[0],
        "mask_embed": None,
    }

    def dec_attn(p: str) -> Dict[str, Any]:
        return {
            "q": _lin(sd, f"{p}.q_proj"),
            "k": _lin(sd, f"{p}.k_proj"),
            "v": _lin(sd, f"{p}.v_proj"),
            "out": _lin(sd, f"{p}.out_proj"),
        }

    def dec_layer(i: int) -> Dict[str, Any]:
        p = f"mask_decoder.transformer.layers.{i}"
        return {
            "self_attn": dec_attn(f"{p}.self_attn"),
            "ln1": _ln(sd, f"{p}.norm1"),
            "t2i": dec_attn(f"{p}.cross_attn_token_to_image"),
            "ln2": _ln(sd, f"{p}.norm2"),
            "mlp1": _lin(sd, f"{p}.mlp.lin1"),
            "mlp2": _lin(sd, f"{p}.mlp.lin2"),
            "ln3": _ln(sd, f"{p}.norm3"),
            "i2t": dec_attn(f"{p}.cross_attn_image_to_token"),
            "ln4": _ln(sd, f"{p}.norm4"),
        }

    def ff(p: str, depth: int) -> Dict[str, Any]:
        # original-SAM MLP: layers.{0..depth-1} Linear list
        return {
            "in": _lin(sd, f"{p}.layers.0"),
            "hidden": [_lin(sd, f"{p}.layers.{i}") for i in range(1, depth - 1)],
            "out": _lin(sd, f"{p}.layers.{depth - 1}"),
        }

    decoder = {
        "iou_token": _np(sd["mask_decoder.iou_token.weight"]),
        "mask_tokens": _np(sd["mask_decoder.mask_tokens.weight"]),
        "layers": [dec_layer(i) for i in range(cfg.decoder_layers)],
        "final_t2i": dec_attn("mask_decoder.transformer.final_attn_token_to_image"),
        "ln_final": _ln(sd, "mask_decoder.transformer.norm_final_attn"),
        # output_upscaling: Sequential(ConvT, LayerNorm2d, GELU, ConvT, GELU);
        # ConvTranspose2d weights are already (in, out, kh, kw) — our layout
        "up1_w": _np(sd["mask_decoder.output_upscaling.0.weight"]),
        "up1_b": _np(sd["mask_decoder.output_upscaling.0.bias"]),
        "up_ln": _ln(sd, "mask_decoder.output_upscaling.1"),
        "up2_w": _np(sd["mask_decoder.output_upscaling.3.weight"]),
        "up2_b": _np(sd["mask_decoder.output_upscaling.3.bias"]),
        "hyper_mlps": [
            ff(f"mask_decoder.output_hypernetworks_mlps.{i}", 3)
            for i in range(cfg.num_mask_tokens)
        ],
        "iou_head": ff("mask_decoder.iou_prediction_head", cfg.iou_head_depth),
    }

    # original SAM has ONE Fourier matrix (the prompt encoder PE layer),
    # used for both the image-wide dense PE and point/box embedding
    pe = _np(sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"])
    return {
        "tinyvit": convert_mobilesam_tinyvit(sd, tcfg),
        "prompt": prompt,
        "decoder": decoder,
        "shared_pe": pe,
        "shared_image_pe": pe,
    }


def is_mobilesam_state_dict(sd: Mapping[str, Any]) -> bool:
    return "image_encoder.patch_embed.seq.0.c.weight" in sd


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


def load_sam_params(checkpoint_path: str, cfg: SamTPUConfig) -> Dict[str, Any]:
    """Load a SAM checkpoint file (.safetensors / torch .bin/.pt) and convert.
    Torch files load with ``weights_only=True``, memory-mapped."""
    if str(checkpoint_path).endswith(".safetensors"):
        try:
            from safetensors.numpy import load_file

            sd = load_file(checkpoint_path)
        except ImportError as e:
            raise RuntimeError("safetensors not available") from e
    else:
        sd = torch_load(checkpoint_path)
        if "state_dict" in sd:
            sd = sd["state_dict"]
    if is_mobilesam_state_dict(sd):
        # TinyViT has no resolution-dependent weights (window-sized
        # attention biases only), so no adapt_resolution step
        return convert_mobilesam_state_dict(sd, cfg)
    params = convert_hf_sam_state_dict(sd, cfg)
    if cfg.image_size != 1024:  # checkpoints are 1024-native
        params = adapt_resolution(params, cfg)
    return params
