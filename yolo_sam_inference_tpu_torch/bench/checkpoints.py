"""Checkpoint-shaped state dicts drawn from a seed, in the public namings.

No published checkpoint is in the repository, so the checkpoint path is
driven by state dicts built here with numpy (values wrapped as CPU torch
tensors, so ``torch.save`` writes them as a trainer would):

* :func:`hf_sam_state_dict`: the ``transformers`` ``SamModel`` naming of
  ``facebook/sam-vit-*`` at the config's own canvas (for ViT-B at 1024:
  ``pos_embed`` (1, 64, 64, 768), windowed rel-pos tables of 27 rows and
  global ones of 127);
* :func:`mobilesam_state_dict`: ``mobile_sam.pt``'s naming: TinyViT's
  ``image_encoder.*`` with Conv2d_BN pairs and BatchNorm statistics,
  attention biases in the official abs-offset column order (with or without
  the ``attention_bias_idxs`` buffers), the prompt encoder and decoder in
  the original segment-anything naming;
* :func:`ultralytics_state_dict`: ultralytics ``DetectionModel`` keys
  (``model.N.*``) with BatchNorm statistics.

Scales follow the numpy inits (linear and conv weights N(0, 1/fan_in),
embeddings 0.02), with biases, LayerNorm affines, rel-pos tables and
attention biases drawn away from 0 and 1 so that each reaches the outputs;
activations stay finite at full depth. Used by the tests and
``chip_smoke.py``; the pipeline never imports this module.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..models.sam.config import SamTPUConfig
from ..models.sam.convert import abs_offset_index
from ..models.sam.tinyvit import TinyViTConfig
from ..models.yolo.config import YoloConfig

StateDict = Dict[str, torch.Tensor]


class _Draw:
    """Named arrays drawn in call order from one numpy generator."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.sd: StateDict = {}

    def put(self, name: str, a) -> None:
        self.sd[name] = torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def normal(self, name: str, shape, scale: float) -> None:
        self.put(name, self.rng.standard_normal(shape, np.float32) * np.float32(scale))

    def linear(self, prefix: str, i: int, o: int, bias: bool = True) -> None:
        self.normal(f"{prefix}.weight", (o, i), 1.0 / math.sqrt(i))
        if bias:
            self.normal(f"{prefix}.bias", (o,), 0.02)

    def conv(self, prefix: str, i: int, o: int, k: int, groups: int = 1,
             bias: bool = True, scale=None) -> None:
        fan = i // groups * k * k
        self.normal(f"{prefix}.weight", (o, i // groups, k, k),
                    1.0 / math.sqrt(fan) if scale is None else scale)
        if bias:
            self.normal(f"{prefix}.bias", (o,), 0.02)

    def layer_norm(self, prefix: str, d: int) -> None:
        self.put(f"{prefix}.weight", 1.0 + 0.1 * self.rng.standard_normal(d, np.float32))
        self.normal(f"{prefix}.bias", (d,), 0.1)

    def batch_norm(self, prefix: str, d: int, tracked: bool) -> None:
        """BatchNorm2d with statistics that are not trivial: gamma in [0.5,
        1.5], running_var in [0.5, 2], running_mean N(0, 0.1)."""
        rng = self.rng
        self.put(f"{prefix}.weight", rng.uniform(0.5, 1.5, d))
        self.normal(f"{prefix}.bias", (d,), 0.1)
        self.normal(f"{prefix}.running_mean", (d,), 0.1)
        self.put(f"{prefix}.running_var", rng.uniform(0.5, 2.0, d))
        if tracked:
            self.sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)


def _decoder(d: _Draw, cfg: SamTPUConfig, original: bool) -> None:
    """The prompt encoder and the mask decoder, in HF's naming or (with
    ``original``) segment-anything's; the same draws in the same order."""
    c, mic = cfg.prompt_hidden, cfg.mask_input_channels
    pe = ("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix" if original
          else "prompt_encoder.shared_embedding.positional_embedding")
    d.normal(pe, (2, cfg.num_pos_feats), cfg.vision_hidden // 2)
    if not original:  # HF carries the image-wide PE apart; checkpoints tie the two
        d.sd["shared_image_embedding.positional_embedding"] = d.sd[pe].clone()
    if original:
        mask = {"conv1": "mask_downscaling.0", "layer_norm1": "mask_downscaling.1",
                "conv2": "mask_downscaling.3", "layer_norm2": "mask_downscaling.4",
                "conv3": "mask_downscaling.6"}
    else:
        mask = {k: f"mask_embed.{k}" for k in ("conv1", "layer_norm1", "conv2",
                                                "layer_norm2", "conv3")}
    p = "prompt_encoder."
    d.conv(p + mask["conv1"], 1, mic // 4, 2)
    d.conv(p + mask["conv2"], mic // 4, mic, 2)
    d.conv(p + mask["conv3"], mic, c, 1)
    d.layer_norm(p + mask["layer_norm1"], mic // 4)
    d.layer_norm(p + mask["layer_norm2"], mic)
    d.normal(p + "no_mask_embed.weight", (1, c), 0.02)
    for i in range(4):
        d.normal(p + f"{'point_embeddings' if original else 'point_embed'}.{i}.weight", (1, c),
                 0.02)
    d.normal(p + "not_a_point_embed.weight", (1, c), 0.02)

    m = "mask_decoder."
    norm = "norm" if original else "layer_norm"
    d.normal(m + "iou_token.weight", (1, c), 0.02)
    d.normal(m + "mask_tokens.weight", (cfg.num_mask_tokens, c), 0.02)

    def attn(prefix: str, internal: int) -> None:
        for proj in ("q_proj", "k_proj", "v_proj"):
            d.linear(f"{prefix}.{proj}", c, internal)
        d.linear(f"{prefix}.out_proj", internal, c)

    t = m + "transformer."
    for i in range(cfg.decoder_layers):
        lp = f"{t}layers.{i}"
        attn(f"{lp}.self_attn", c)
        d.layer_norm(f"{lp}.{norm}1", c)
        attn(f"{lp}.cross_attn_token_to_image", c // 2)
        d.layer_norm(f"{lp}.{norm}2", c)
        d.linear(f"{lp}.mlp.lin1", c, cfg.decoder_mlp_dim)
        d.linear(f"{lp}.mlp.lin2", cfg.decoder_mlp_dim, c)
        d.layer_norm(f"{lp}.{norm}3", c)
        d.layer_norm(f"{lp}.{norm}4", c)
        attn(f"{lp}.cross_attn_image_to_token", c // 2)
    attn(t + "final_attn_token_to_image", c // 2)
    d.layer_norm(t + ("norm_final_attn" if original else "layer_norm_final_attn"), c)
    up1, up_ln, up2 = (("output_upscaling.0", "output_upscaling.1", "output_upscaling.3")
                       if original else ("upscale_conv1", "upscale_layer_norm",
                                         "upscale_conv2"))
    # ConvTranspose2d weights are (in, out, kh, kw)
    d.normal(m + up1 + ".weight", (c, c // 4, 2, 2), 0.02)
    d.normal(m + up1 + ".bias", (c // 4,), 0.02)
    d.normal(m + up2 + ".weight", (c // 4, c // 8, 2, 2), 0.02)
    d.normal(m + up2 + ".bias", (c // 8,), 0.02)
    d.layer_norm(m + up_ln, c // 4)

    def mlp(prefix: str, i: int, h: int, o: int, depth: int) -> None:
        dims = [i] + [h] * (depth - 1) + [o]
        for j in range(depth):
            if original:
                name = f"layers.{j}"
            else:
                name = "proj_in" if j == 0 else ("proj_out" if j == depth - 1
                                                 else f"layers.{j - 1}")
            d.linear(f"{prefix}.{name}", dims[j], dims[j + 1])

    for i in range(cfg.num_mask_tokens):
        mlp(f"{m}output_hypernetworks_mlps.{i}", c, c, c // 8, 3)
    mlp(m + "iou_prediction_head", c, cfg.iou_head_hidden, cfg.num_mask_tokens,
        cfg.iou_head_depth)


def hf_sam_state_dict(cfg: SamTPUConfig, seed: int) -> StateDict:
    """A ``SamModel`` state dict (HF naming) at ``cfg``'s widths, depth and
    canvas: the vision encoder (positional embedding on the grid of
    ``cfg.image_size``, windowed rel-pos tables of 2 window - 1 rows,
    global ones of 2 grid - 1), prompt encoder and mask decoder."""
    d = _Draw(seed)
    c, hd, gs = cfg.vision_hidden, cfg.vision_hidden // cfg.vision_heads, cfg.grid_size
    v = "vision_encoder."
    d.normal(v + "pos_embed", (1, gs, gs, c), 0.1)
    d.conv(v + "patch_embed.projection", 3, c, cfg.patch_size, scale=0.02)
    for i in range(cfg.vision_layers):
        lp = f"{v}layers.{i}"
        rows = 2 * (gs if i in cfg.global_attn_indexes else cfg.window_size) - 1
        d.layer_norm(f"{lp}.layer_norm1", c)
        d.normal(f"{lp}.attn.rel_pos_h", (rows, hd), 0.1)
        d.normal(f"{lp}.attn.rel_pos_w", (rows, hd), 0.1)
        d.linear(f"{lp}.attn.qkv", c, 3 * c)
        d.linear(f"{lp}.attn.proj", c, c)
        d.layer_norm(f"{lp}.layer_norm2", c)
        d.linear(f"{lp}.mlp.lin1", c, cfg.vision_mlp_dim)
        d.linear(f"{lp}.mlp.lin2", cfg.vision_mlp_dim, c)
    oc = cfg.output_channels
    d.conv(v + "neck.conv1", c, oc, 1, bias=False, scale=0.02)
    d.layer_norm(v + "neck.layer_norm1", oc)
    d.conv(v + "neck.conv2", oc, oc, 3, bias=False, scale=0.02)
    d.layer_norm(v + "neck.layer_norm2", oc)
    _decoder(d, cfg, original=False)
    return d.sd


def mobilesam_state_dict(tcfg: TinyViTConfig, cfg: SamTPUConfig, seed: int,
                         with_bias_idxs: bool = True) -> StateDict:
    """A ``mobile_sam.pt`` state dict: TinyViT (``tcfg``) under
    ``image_encoder.*``, the prompt encoder and decoder (``cfg``) in the
    original segment-anything naming. ``with_bias_idxs=False`` leaves out the
    ``attention_bias_idxs`` buffers, as the official code (which registers
    them ``persistent=False``) may save it."""
    d = _Draw(seed)
    e = "image_encoder."

    def conv_bn(prefix: str, i: int, o: int, k: int, groups: int = 1) -> None:
        d.conv(f"{e}{prefix}.c", i, o, k, groups, bias=False)
        d.batch_norm(f"{e}{prefix}.bn", o, tracked=True)

    d0, d1, d2, d3 = tcfg.embed_dims
    conv_bn("patch_embed.seq.0", 3, d0 // 2, 3)
    conv_bn("patch_embed.seq.2", d0 // 2, d0, 3)
    h = int(d0 * tcfg.mbconv_expand)
    for i in range(tcfg.depths[0]):
        p = f"layers.0.blocks.{i}"
        conv_bn(f"{p}.conv1", d0, h, 1)
        conv_bn(f"{p}.conv2", h, h, 3, groups=h)
        conv_bn(f"{p}.conv3", h, d0, 1)

    def merge(prefix: str, ci: int, co: int) -> None:
        conv_bn(f"{prefix}.conv1", ci, co, 1)
        conv_bn(f"{prefix}.conv2", co, co, 3, groups=co)
        conv_bn(f"{prefix}.conv3", co, co, 1)

    merge("layers.0.downsample", d0, d1)
    dims = (None, d1, d2, d3)
    for si in (1, 2, 3):
        c, heads, ws = dims[si], tcfg.num_heads[si], tcfg.window_sizes[si]
        hid = int(c * tcfg.mlp_ratio)
        idx = abs_offset_index(ws)
        for i in range(tcfg.depths[si]):
            p = f"{e}layers.{si}.blocks.{i}"
            d.layer_norm(f"{p}.attn.norm", c)
            d.linear(f"{p}.attn.qkv", c, 3 * c)
            d.linear(f"{p}.attn.proj", c, c)
            d.normal(f"{p}.attn.attention_biases", (heads, int(idx.max()) + 1), 0.5)
            if with_bias_idxs:
                d.sd[f"{p}.attn.attention_bias_idxs"] = torch.from_numpy(idx.astype(np.int64))
            conv_bn(f"layers.{si}.blocks.{i}.local_conv", c, c, 3, groups=c)
            d.layer_norm(f"{p}.mlp.norm", c)
            d.linear(f"{p}.mlp.fc1", c, hid)
            d.linear(f"{p}.mlp.fc2", hid, c)
        if si < 3:
            merge(f"layers.{si}.downsample", c, dims[si + 1])
    oc = tcfg.output_channels
    d.conv(e + "neck.0", d3, oc, 1, bias=False, scale=0.02)
    d.layer_norm(e + "neck.1", oc)
    d.conv(e + "neck.2", oc, oc, 3, bias=False, scale=0.02)
    d.layer_norm(e + "neck.3", oc)
    _decoder(d, cfg, original=True)
    return d.sd


def ultralytics_state_dict(ycfg: YoloConfig, seed: int) -> StateDict:
    """An ultralytics ``DetectionModel`` state dict (``model.N.*``) at
    ``ycfg``'s widths and depths: Conv = conv (no bias) + BatchNorm, the
    detect head's last 1x1s with bias."""
    d = _Draw(seed)

    def conv(prefix: str, ci: int, co: int, k: int) -> None:
        d.conv(f"{prefix}.conv", ci, co, k, bias=False)
        d.batch_norm(f"{prefix}.bn", co, tracked=False)

    def c2f(prefix: str, ci: int, co: int, n: int) -> None:
        c = co // 2
        conv(f"{prefix}.cv1", ci, 2 * c, 1)
        conv(f"{prefix}.cv2", (2 + n) * c, co, 1)
        for i in range(n):
            conv(f"{prefix}.m.{i}.cv1", c, c, 3)
            conv(f"{prefix}.m.{i}.cv2", c, c, 3)

    c1, c2, c3, c4, c5 = ycfg.stage_channels
    n1, n2 = ycfg.depth(3), ycfg.depth(6)
    conv("model.0", 3, c1, 3)
    conv("model.1", c1, c2, 3)
    c2f("model.2", c2, c2, n1)
    conv("model.3", c2, c3, 3)
    c2f("model.4", c3, c3, n2)
    conv("model.5", c3, c4, 3)
    c2f("model.6", c4, c4, n2)
    conv("model.7", c4, c5, 3)
    c2f("model.8", c5, c5, n1)
    conv("model.9.cv1", c5, c5 // 2, 1)
    conv("model.9.cv2", c5 * 2, c5, 1)
    c2f("model.12", c5 + c4, c4, n1)
    c2f("model.15", c4 + c3, c3, n1)
    conv("model.16", c3, c3, 3)
    c2f("model.18", c3 + c4, c4, n1)
    conv("model.19", c4, c4, 3)
    c2f("model.21", c4 + c5, c5, n1)
    bc, cc = ycfg.box_branch_ch, ycfg.cls_branch_ch
    for lvl, ci in enumerate(ycfg.detect_channels):
        conv(f"model.22.cv2.{lvl}.0", ci, bc, 3)
        conv(f"model.22.cv2.{lvl}.1", bc, bc, 3)
        d.conv(f"model.22.cv2.{lvl}.2", bc, 4 * ycfg.reg_max, 1)
        conv(f"model.22.cv3.{lvl}.0", ci, cc, 3)
        conv(f"model.22.cv3.{lvl}.1", cc, cc, 3)
        d.conv(f"model.22.cv3.{lvl}.2", cc, ycfg.num_classes, 1)
    return d.sd


__all__ = ["hf_sam_state_dict", "mobilesam_state_dict", "ultralytics_state_dict"]
