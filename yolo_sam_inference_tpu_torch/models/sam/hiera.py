"""SAM 2's image path: the Hiera trunk and FPN neck, and the model around them.

Follows ``sam2/modeling/backbones/hieradet.py`` (trunk), ``image_encoder.py``
(neck), ``sam/mask_decoder.py`` and ``sam2_image_predictor.py`` (the image
predictor's single-mask output):

* :class:`HieraImageEncoder`: a 7x7 stride-4 patch embedding, the position
  table (a background table resized bicubically to the token grid, plus a
  window table tiled over it; made once when the module is built), the
  stages of :class:`HieraBlock`, then the FPN neck: a 1x1 lateral conv a
  level, nearest 2x top-down sums at ``fpn_top_down_levels``, the coarsest
  ``scalp`` levels dropped. It returns the image embedding (the last level
  kept, plus ``no_mem_embed``) and the decoder's projections of levels 1 and
  0 (``conv_s1``, ``conv_s0``), which SAM 2 computes once an image.
* :class:`HieraBlock`: LN1, windowed (or global) attention whose queries are
  max-pooled 2x2 at a stage's first block, the shortcut there a projection
  max-pooled the same way, then LN2 and the GELU MLP. Every linear layer runs
  on ``gemm_bf16`` (its LayerNorm prologue takes LN1 and LN2 at every Hiera
  width; at a pooling block one product gives qkv and the shortcut), the
  attention on ``ops/hiera_attention.py`` (one kernel that reads each
  window's q, k and v where the qkv product wrote them; head dim 72 at
  Hiera-L).
* :class:`Sam2Model`: the encoder with SAM's prompt encoder and two-way
  decoder (the object-score token first) and SAM 2's mask head:
  :meth:`Sam2Model.upscale` adds ``feat_s1`` after the first transposed
  conv and ``feat_s0`` after the second; :meth:`Sam2Model.choose` is the
  stability choice over token 0's whole low-res mask; ``encode`` and
  ``segment_windows`` are the engine's calls.

Windows must divide each block's token grid (they do at every canvas that is
a multiple of 256 at Hiera-L's windows); SAM 2 zero-pads, which no such
canvas needs.

Trees (numpy leaves, ``init_sam2_params``; the benchmark draws its own):
linear weights ``(in, out)``, the patch embedding HWIO, the position tables
``(side, side, C)``, the mask head's transposed convs ``(in, out, 2, 2)``.
"""

from __future__ import annotations

import math
import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.constants import constant
from ...ops.fused_ln import fused_ln_mlp, gemm_bf16, gemm_plain, linear
from ...ops.hiera_attention import hiera_window_attention, hiera_window_attention_plain
from ...ops.window_crop import window_crop
from ...utils.spans import span
from .config import Sam2Config
from .model import (
    Linear,
    Norm,
    Params,
    SamMaskDecoder,
    SamPromptEncoder,
    _conv_transpose_2x,
    _param,
)


def position_table(pos: np.ndarray, window: np.ndarray, grid: int) -> torch.Tensor:
    """(1, grid, grid, C) fp32: the background table (b, b, C) resized
    bicubically to the grid (``F.interpolate``, corners not aligned) plus the
    window table (w, w, C) tiled over it (hieradet ``_get_pos_embed``)."""
    p = torch.as_tensor(np.asarray(pos, np.float32)).permute(2, 0, 1)[None]
    w = torch.as_tensor(np.asarray(window, np.float32)).permute(2, 0, 1)[None]
    if grid % w.shape[-1]:
        raise ValueError(f"the window position table ({w.shape[-1]}) does not tile a "
                         f"{grid}-token grid")
    p = F.interpolate(p, size=(grid, grid), mode="bicubic")
    reps = grid // w.shape[-1]
    return (p + w.tile(1, 1, reps, reps)).permute(0, 2, 3, 1).contiguous()


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool of (..., S, S, C) (S even) -> (..., S/2, S/2, C)."""
    *lead, s, _, c = x.shape
    return x.reshape(*lead, s // 2, 2, s // 2, 2, c).amax(dim=(-4, -2))


class HieraBlock(nn.Module):
    """One Hiera block on (B, S, S, dim) -> (B, S', S', dim_out)."""

    def __init__(self, p: Params, dim: int, dim_out: int, heads: int, window: int, pool: bool,
                 eps: float):
        super().__init__()
        self.dim, self.dim_out, self.heads = dim, dim_out, heads
        self.window, self.pool = window, pool
        self.ln1, self.ln2 = Norm(p["ln1"], eps), Norm(p["ln2"], eps)
        if dim != dim_out:  # one product from LN1: [qkv | shortcut]
            self.qkv = Linear({"w": np.concatenate([p["qkv"]["w"], p["shortcut"]["w"]], 1),
                               "b": np.concatenate([p["qkv"]["b"], p["shortcut"]["b"]])})
        else:
            self.qkv = Linear(p["qkv"])
        self.proj, self.mlp1, self.mlp2 = Linear(p["proj"]), Linear(p["mlp1"]), Linear(p["mlp2"])

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        gemm = gemm_plain if plain else gemm_bf16
        attn = hiera_window_attention_plain if plain else hiera_window_attention
        b, s, _, c = x.shape
        co = self.dim_out
        ln1, ln2 = self.ln1, self.ln2
        y = gemm(x.reshape(-1, c), self.qkv.w, self.qkv.b, ln=(ln1.scale, ln1.bias, ln1.eps))
        qkv = y[:, :3 * co].reshape(b, s, s, 3 * co)
        shortcut = x
        if c != co:  # the projected LN1 output, pooled as the queries are
            shortcut = y[:, 3 * co:].reshape(b, s, s, co)
            shortcut = max_pool2(shortcut) if self.pool else shortcut.contiguous()
        h = linear(attn(qkv, self.heads, self.window, self.pool), self.proj.w, self.proj.b,
                   gemm=gemm)
        return fused_ln_mlp(shortcut, h, ln2.scale, ln2.bias, self.mlp1.w, self.mlp1.b,
                            self.mlp2.w, self.mlp2.b, eps=ln2.eps, gemm=gemm)


class HieraImageEncoder(nn.Module):
    """The Hiera trunk and FPN neck. ``forward(pix)``: (B, H, W, 3)
    normalised -> (embedding (B, gs, gs, C), feat_s1 (B, 2 gs, 2 gs, C / 4),
    feat_s0 (B, 4 gs, 4 gs, C / 8)). Its spans: ``hiera_fine`` (the patch
    embedding, the positions and stages 1-2) and ``hiera_coarse`` (stages 3-4,
    the neck, ``conv_s1`` and ``conv_s0``); ``mark`` makes them (the engine's
    synchronised path passes one that also times them)."""

    def __init__(self, p: Params, cfg: Sam2Config):
        super().__init__()
        self.cfg = cfg
        pw = np.asarray(p["patch_embed"]["w"])  # (k, k, 3, C) HWIO
        self.patch_w = _param(pw.transpose(3, 2, 0, 1))
        self.patch_b = _param(p["patch_embed"]["b"])
        self.pos = _param(position_table(p["pos_embed"], p["pos_embed_window"], cfg.trunk_grid))
        eps = cfg.layer_norm_eps
        self.blocks = nn.ModuleList(HieraBlock(bp, *spec, eps)
                                    for bp, spec in zip(p["blocks"], cfg.blocks()))
        for side, _, window, pool in cfg.attention():
            if side % (window or side) or (pool and (window or side) % 2):
                raise ValueError(f"Hiera: window {window} does not tile the {side}-token "
                                 f"grid at canvas {cfg.image_size}")
        n = p["neck"]
        self.lateral = nn.ModuleList(Linear(lp) for lp in n["lateral"])  # fine to coarse
        self.conv_s0, self.conv_s1 = Linear(n["conv_s0"]), Linear(n["conv_s1"])
        self.no_mem_embed = _param(p["no_mem_embed"])

    def forward(self, pix: torch.Tensor, plain: bool = False, mark=span):
        split = self.cfg.stage_ends[1] + 1
        with mark("hiera_fine"):
            x = self.patch_embed(pix)
            feats = self.stages(x, 0, split, plain)
        with mark("hiera_coarse"):
            feats += self.stages(feats[-1], split, len(self.blocks), plain)
            return self.neck(feats, plain)

    def patch_embed(self, pix: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H / 4, W / 4, C): the 7x7 stride-4 conv plus the
        position table."""
        cfg = self.cfg
        x = F.conv2d(pix.permute(0, 3, 1, 2), self.patch_w, self.patch_b,
                     stride=cfg.patch_stride, padding=cfg.patch_kernel // 2)
        return x.permute(0, 2, 3, 1) + self.pos

    def stages(self, x: torch.Tensor, first: int, last: int, plain: bool = False):
        """Blocks ``first`` to ``last - 1`` on x -> the outputs of the stages
        that end among them."""
        out = []
        for i in range(first, last):
            x = self.blocks[i](x, plain)
            if i in self.cfg.stage_ends:
                out.append(x)
        return out

    def neck(self, feats, plain: bool = False):
        """The FPN over the stages' outputs (fine to coarse) -> (embedding,
        feat_s1, feat_s0)."""
        gemm = gemm_plain if plain else gemm_bf16
        cfg = self.cfg
        out = [None] * len(feats)
        prev = None
        for i in range(len(feats) - 1, -1, -1):
            x, lat = feats[i], self.lateral[i]
            b, s = x.shape[:2]
            up = None
            if i in cfg.fpn_top_down_levels and prev is not None:  # nearest 2x, summed
                up = prev[:, :, None, :, None].expand(b, s // 2, 2, s // 2, 2, prev.shape[-1])
                up = up.reshape(b * s * s, -1)
            prev = gemm(x.reshape(-1, x.shape[-1]), lat.w, lat.b, r1=up).reshape(b, s, s, -1)
            out[i] = prev
        kept = out[:len(out) - cfg.scalp]
        emb = kept[-1] + self.no_mem_embed
        s1 = linear(kept[1], self.conv_s1.w, self.conv_s1.b, gemm=gemm)
        s0 = linear(kept[0], self.conv_s0.w, self.conv_s0.b, gemm=gemm)
        return emb, s1, s0


# fp32 bytes of the upscaled prompts that one chunk of SAM 2's head holds
SAM2_HEAD_BYTES = 1 << 30


class Sam2Model(nn.Module):
    """Hiera encoder + SAM's prompt encoder + the mask decoder with SAM 2's
    head, from one tree (:func:`init_sam2_params`)."""

    def __init__(self, params: Params, cfg: Sam2Config):
        super().__init__()
        self.cfg = cfg
        self.vision = HieraImageEncoder(params["vision"], cfg)
        self.prompt = SamPromptEncoder(params["prompt"], params["shared_pe"], cfg,
                                       params.get("shared_image_pe"))
        self.decoder = SamMaskDecoder(params["decoder"], cfg)

    def encode(self, pix: torch.Tensor, mark=span):
        """The engine's embed call: (B, S, S, 3) normalised canvas pixels ->
        (embedding, feat_s1, feat_s0) in the compute dtype; ``mark`` makes the
        encoder's spans ``hiera_fine`` and ``hiera_coarse``."""
        return self.vision(pix, mark=mark)

    def segment_windows(self, feats, boxes, windows, mark=span):
        """The engine's segment call: (embedding, feat_s1, feat_s0) and box
        prompts (B, K, 4) in canvas pixels -> (the chosen token's logits
        sampled onto each prompt's crop (B*K, crop, crop) fp32, the chosen
        token (B*K,)). The decoder runs on 9 tokens a prompt; then, in the
        span ``sam2_head`` and a chunk of images at a time
        (``SAM2_HEAD_BYTES``): every prompt's whole upscaling with its image's
        high-resolution levels, token 0's logits over the whole low-res grid
        for the stability choice (:meth:`choose`), the chosen token's logits
        on the prompt's window (K8 on the upscaled grid at 4x the window's
        start), and the crop's samples."""
        emb, feat_s1, feat_s0 = feats
        b, k = boxes.shape[0], boxes.shape[1]
        gs = self.cfg.grid_size
        sparse = self.box_prompts(boxes).to(emb.dtype)
        iou, hyper, keys = self.mask_decoder_tokens(emb, sparse)
        with mark("sam2_head"):
            iou = iou.reshape(b * k, -1)
            low_start = windows.starts * 4
            c8 = feat_s0.shape[-1]
            per_image = max(1, k * (4 * gs) ** 2 * c8 * 4)
            step = max(1, SAM2_HEAD_BYTES // per_image)
            parts, tokens = [], []
            for i0 in range(0, b, step):
                p0, p1 = i0 * k, min(b, i0 + step) * k
                up = self.upscale(keys[p0:p1], feat_s1[i0:i0 + step], feat_s0[i0:i0 + step])
                hy = hyper[p0:p1].float()
                logits0 = torch.einsum("npc,nc->np", up.flatten(1, 2).float(), hy[:, 0])
                choice = self.choose(logits0, iou[p0:p1])
                tokens.append(choice)
                chosen = hy.gather(1, choice[:, None, None].expand(-1, 1, c8))[:, 0]
                win = window_crop(up, low_start[p0:p1, 0], low_start[p0:p1, 1], 4 * windows.side)
                parts.append(torch.einsum("nhwc,nc->nhw", win.float(), chosen))
            crops = windows.sample(torch.cat(parts), low_start)
        return crops, torch.cat(tokens)

    def box_prompts(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, K, 4) xyxy boxes in canvas pixels -> (B, K, 3, C) fp32: the
        corners as points labelled 2 and 3 and, the prompt having no box
        field, one padding point (SAM 2's predictor)."""
        b, k = boxes.shape[:2]
        labels = constant((2, 3), torch.int64, boxes.device).expand(b, k, 2)
        return self.prompt.points(boxes.reshape(b, k, 2, 2), labels, pad=True)

    def mask_decoder_tokens(self, image_embeddings, sparse_prompts, plain: bool = False):
        """The two-way transformer: (iou (B, K, M) before the sigmoid, hyper
        (B*K, M, C/8), keys (B*K, gs, gs, C))."""
        return self.decoder.tokens(image_embeddings, sparse_prompts, self.prompt.image_pe(),
                                   self.prompt.no_mask.to(image_embeddings.dtype), plain)

    def upscale(self, keys: torch.Tensor, feat_s1: torch.Tensor, feat_s0: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
        """SAM 2's upscaling of the keys of K prompts an image, (B*K, g, g, C),
        with its images' high-resolution levels (B, 2g, 2g, C/4), (B, 4g, 4g,
        C/8): GELU(LN(up1(keys) + feat_s1)), then GELU(up2(.) + feat_s0) ->
        (B*K, 4g, 4g, C/8)."""
        d = self.decoder
        b = feat_s1.shape[0]
        k = keys.shape[0] // b
        up = _conv_transpose_2x(keys, d.up1_w, d.up1_b)
        up = (up.unflatten(0, (b, k)) + feat_s1[:, None]).flatten(0, 1)
        up = F.gelu(d.up_ln(up, plain))
        up = _conv_transpose_2x(up, d.up2_w, d.up2_b)
        return F.gelu((up.unflatten(0, (b, k)) + feat_s0[:, None]).flatten(0, 1))

    def choose(self, logits0: torch.Tensor, iou: torch.Tensor) -> torch.Tensor:
        """The single mask's token a prompt: 0 where token 0's low-res logits
        (N, P) are stable (pixels above +delta over pixels above -delta, 1
        where none is above -delta, at least the threshold), else the best of
        tokens 1.. by iou (N, M) -> (N,) int64."""
        cfg = self.cfg
        area_i = (logits0 > cfg.stability_delta).sum(-1).float()
        area_u = (logits0 > -cfg.stability_delta).sum(-1).float()
        stability = torch.where(area_u > 0, area_i / area_u.clamp(min=1.0), 1.0)
        best = iou[:, 1:].argmax(-1) + 1
        return torch.where(stability >= cfg.stability_thresh, torch.zeros_like(best), best)

    def low_res_masks(self, image_embeddings, feat_s1, feat_s0, sparse_prompts,
                      plain: bool = False):
        """Every prompt's chosen low-res mask on the whole grid: (logits (B, K,
        4gs, 4gs) fp32, chosen token (B, K), iou (B, K) after the sigmoid).
        :meth:`segment_windows` computes the same a window at a time."""
        b, k = sparse_prompts.shape[:2]
        iou, hyper, keys = self.mask_decoder_tokens(image_embeddings, sparse_prompts, plain)
        up = self.upscale(keys, feat_s1, feat_s0, plain)
        n, side = up.shape[0], up.shape[1]
        logits = torch.einsum("npc,nmc->nmp", up.reshape(n, side * side, -1).float(),
                              hyper.float())
        iou = iou.reshape(n, -1)
        choice = self.choose(logits[:, 0], iou)
        idx = torch.arange(n, device=up.device)
        return (logits[idx, choice].reshape(b, k, side, side), choice.reshape(b, k),
                torch.sigmoid(iou[idx, choice].float()).reshape(b, k))


# ------------------------------------------------------------------------- init


def init_sam2_params(seed: int, cfg: Sam2Config) -> Params:
    """A random SAM 2 tree, host numpy fp32: weights N(0, 1 / fan-in), biases,
    LayerNorm shifts and tables small, LayerNorm gains near 1."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    def dense(i, o):
        return {"w": randn(i, o, scale=1.0 / math.sqrt(i)), "b": randn(o, scale=0.02)}

    def ln(d):
        return {"scale": 1.0 + randn(d, scale=0.1), "bias": randn(d, scale=0.02)}

    c0, k = cfg.embed_dim, cfg.patch_kernel
    blocks = []
    for dim, dim_out, _, _, _ in cfg.blocks():
        blk = {"ln1": ln(dim), "qkv": dense(dim, 3 * dim_out), "proj": dense(dim_out, dim_out),
               "ln2": ln(dim_out), "mlp1": dense(dim_out, int(dim_out * cfg.mlp_ratio)),
               "mlp2": dense(int(dim_out * cfg.mlp_ratio), dim_out)}
        if dim != dim_out:
            blk["shortcut"] = dense(dim, dim_out)
        blocks.append(blk)
    oc = cfg.output_channels
    vision = {
        "patch_embed": {"w": randn(k, k, 3, c0, scale=1.0 / math.sqrt(k * k * 3)),
                        "b": randn(c0, scale=0.02)},
        "pos_embed": randn(cfg.pos_embed_bkg, cfg.pos_embed_bkg, c0, scale=0.1),
        "pos_embed_window": randn(cfg.window_spec[0], cfg.window_spec[0], c0, scale=0.1),
        "blocks": blocks,
        "neck": {"lateral": [dense(d, oc) for d in cfg.stage_dims],
                 "conv_s0": dense(oc, oc // 8), "conv_s1": dense(oc, oc // 4)},
        "no_mem_embed": randn(oc, scale=0.1),
    }
    ph = cfg.prompt_hidden
    prompt = {"point_embed": randn(4, ph), "not_a_point": randn(ph),
              "no_mask": randn(ph, scale=0.1), "mask_embed": None}
    di, down = ph, ph // 2

    def attn(inner):
        return {"q": dense(di, inner), "k": dense(di, inner), "v": dense(di, inner),
                "out": dense(inner, di)}

    def ff(i, h, o, depth):
        return {"in": dense(i, h), "hidden": [dense(h, h) for _ in range(depth - 2)],
                "out": dense(h, o)}

    m = cfg.num_mask_tokens
    decoder = {
        "obj_score_token": randn(1, di), "iou_token": randn(1, di), "mask_tokens": randn(m, di),
        "layers": [{"self_attn": attn(di), "ln1": ln(di), "t2i": attn(down), "ln2": ln(di),
                    "mlp1": dense(di, cfg.decoder_mlp_dim), "mlp2": dense(cfg.decoder_mlp_dim, di),
                    "ln3": ln(di), "i2t": attn(down), "ln4": ln(di)}
                   for _ in range(cfg.decoder_layers)],
        "final_t2i": attn(down), "ln_final": ln(di),
        "up1_w": randn(di, di // 4, 2, 2, scale=1.0 / math.sqrt(di)),
        "up1_b": randn(di // 4, scale=0.02), "up_ln": ln(di // 4),
        "up2_w": randn(di // 4, di // 8, 2, 2, scale=1.0 / math.sqrt(di // 4)),
        "up2_b": randn(di // 8, scale=0.02),
        "hyper_mlps": [ff(di, di, di // 8, 3) for _ in range(m)],
        "iou_head": ff(di, cfg.iou_head_hidden, m, cfg.iou_head_depth),
    }
    shared_pe = randn(2, cfg.num_pos_feats)
    return {"vision": vision, "prompt": prompt, "decoder": decoder, "shared_pe": shared_pe,
            "shared_image_pe": shared_pe}


__all__ = ["HieraBlock", "HieraImageEncoder", "Sam2Model", "init_sam2_params", "position_table"]
