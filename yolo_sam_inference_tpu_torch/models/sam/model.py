"""SAM as ``nn.Module``s: ViT image encoder, box prompt encoder, mask decoder.

Counterpart of ``yolo_sam_inference_tpu/models/sam/model.py``:

* :class:`SamImageEncoder` takes the JAX encoder's two routes. The grid
  route (JAX ``:334-418``) keeps activations ``(B, S, S, C)`` and handles
  windows inside attention. Per layer: LN1 + qkv, window attention with the
  decomposed rel-pos bias, the output projection, and the LN2 + MLP block
  tail (:class:`VisionLayer`). The flat route (JAX ``:420-461``) serves
  grids the window does not divide, and grids in windows of 14
  (:meth:`SamImageEncoder.grid_route`): windows are zero-padded partitions,
  every attention runs on K12 (:func:`_vision_attention`), and the block
  tails carry the MLP residual into the next LayerNorm (K11d). With int8
  weights its qkv, mlp1 and mlp2 run on ``int8_linear`` (JAX
  ``apply_linear``; the projection stays float). Then the
  neck (1x1 conv, LN, 3x3 conv, LN); with ``conv2d_fused`` its 3x3 runs on
  ``conv2d_act`` (K17), else on ``F.conv2d``.
* :class:`SamPromptEncoder` encodes box prompts with fp32 Fourier features.
* :class:`SamMaskDecoder` is the two-way transformer in the order of the
  JAX package's fused branch (``:736-817``): layer 0's token-to-image
  attention against per-image keys (K6, ``t2i_shared_attend``), then one pass
  over the keys stream per layer (K7, ``i2t_keys_update``) that also feeds
  the next token-to-image attention; and the mask head (``sam_mask_head``).

Linear weights keep the JAX layout ``(in, out)`` (``x @ w + b``); conv
weights are stored OIHW for ``F.conv2d``, HWIO for ``conv2d_act``. Modules
are built from a parameter tree in the JAX package's layout
(:func:`init_sam_params`).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.conv2d_fused import conv2d_act, conv2d_act_plain
from ...ops.decoder_fused import (
    i2t_keys_update,
    i2t_keys_update_plain,
    t2i_shared_attend,
    t2i_shared_attend_plain,
)
from ...ops.flash_attention import (
    K12_WINDOW,
    relpos_grid_attention,
    window_attention,
    window_attention_plain,
)
from ...ops.fused_ln import (
    fused_ln_matmul,
    fused_ln_matmul_int8,
    fused_ln_matmul_int8_plain,
    fused_ln_mlp,
    fused_ln_mlp_int8,
    fused_ln_mlp_int8_plain,
    fused_ln_mlp_tiled_int8,
    gemm_bf16,
    gemm_plain,
    int8_linear,
    int8_linear_plain,
    int8_tail_chunks,
    layer_norm,
    layer_norm_plain,
    linear,
)
from ...ops.quant import is_quantized
from ...ops.window_crop import window_crop
from ...utils.spans import span
from .config import SamTPUConfig
from .tinyvit import TinyViT, TinyViTConfig, is_tinyvit

Params = Dict[str, Any]


def _param(a) -> nn.Parameter:
    """A frozen parameter from a tree leaf: int8 stays int8, the rest is fp32."""
    arr = np.asarray(a)
    arr = np.array(arr) if arr.dtype == np.int8 else arr.astype(np.float32)
    return nn.Parameter(torch.as_tensor(arr), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.w, self.b = _param(p["w"]), _param(p["b"])

    def forward(self, x):
        return x @ self.w + self.b


class Int8Linear(nn.Module):
    """A quantised record ``{"wq", "wscale", "b"}``: int8 (in, out) weight,
    fp32 per-column scales (kept fp32 by ``weights.from_jax_params``). The
    encoder applies it through the w8a8 kernels of :class:`VisionLayer`, or
    on the flat route through :func:`_project`."""

    def __init__(self, p: Params):
        super().__init__()
        self.wq, self.wscale, self.b = _param(p["wq"]), _param(p["wscale"]), _param(p["b"])


def _linear(p: Params) -> nn.Module:
    return Int8Linear(p) if is_quantized(p) else Linear(p)


class Norm(nn.Module):
    """LayerNorm parameters; applied through the LN kernel (or its plain version)."""

    def __init__(self, p: Params, eps: float):
        super().__init__()
        self.scale, self.bias, self.eps = _param(p["scale"]), _param(p["bias"]), eps

    def forward(self, x, plain: bool = False):
        fn = layer_norm_plain if plain else layer_norm
        return fn(x, self.scale, self.bias, self.eps)


# ---------------------------------------------------------------- image encoder


# C * hidden up to which the TPU kernels keep both int8 MLP weights in VMEM
# (JAX ``models/sam/model.py:339-348``): int8 ViT-B/L take the resident
# K11a, ViT-H the tiled K11b, and the chunk count follows that choice. (The
# bf16 K4/K10 choice, at 2.4M, changes no result, so the port has none.)
RESIDENT_MLP_INT8_MAX = 4_500_000


class VisionLayer(nn.Module):
    """One encoder layer. Routes, as the JAX encoder picks them
    (``model.py:155-178``, ``:339-409``): float weights take K1 (LN1 + qkv),
    then the K4/K10 tail (one function, :func:`fused_ln_mlp`); int8 weights
    take K11c, then the K11a or K11b tail. The attention projection stays a
    float GEMM in both."""

    def __init__(self, p: Params, eps: float):
        super().__init__()
        a = p["attn"]
        self.ln1, self.ln2 = Norm(p["ln1"], eps), Norm(p["ln2"], eps)
        self.qkv, self.proj = _linear(a["qkv"]), Linear(a["proj"])
        self.rel_pos_h, self.rel_pos_w = _param(a["rel_pos_h"]), _param(a["rel_pos_w"])
        self.mlp1, self.mlp2 = _linear(p["mlp1"]), _linear(p["mlp2"])
        self.int8 = isinstance(self.mlp1, Int8Linear)
        self.tiled = self.int8 and np.size(p["mlp1"]["wq"]) > RESIDENT_MLP_INT8_MAX

    def forward(self, x, heads: int, window: int, plain: bool = False, tp=None):
        """x (B, S, S, C) -> (B, S, S, C). ``plain`` runs every kernel's
        plain PyTorch version, on any device (the fp32 oracle). ``tp`` (a
        ``parallel.tp.TPGroup``): the layer is its rank's shard of a
        tensor-parallel group, ``heads`` the rank's (:meth:`_tail_tp`)."""
        gemm = {"gemm": gemm_plain} if plain else {}
        attn = window_attention_plain if plain else window_attention
        ln1, ln2 = self.ln1, self.ln2
        if self.int8:
            qkv_fn = fused_ln_matmul_int8_plain if plain else fused_ln_matmul_int8
            qkv = qkv_fn(x, ln1.scale, ln1.bias, self.qkv.wq, self.qkv.wscale, self.qkv.b,
                         eps=ln1.eps)
        else:
            qkv = fused_ln_matmul(_copy(tp, x), ln1.scale, ln1.bias, self.qkv.w, self.qkv.b,
                                  eps=ln1.eps, **gemm)
        h = attn(qkv, self.rel_pos_h, self.rel_pos_w, heads, window)
        if tp is not None:
            return self._tail_tp(x, h, tp, plain)
        h = linear(h, self.proj.w, self.proj.b, **gemm)
        if not self.int8:
            return fused_ln_mlp(x, h, ln2.scale, ln2.bias, self.mlp1.w, self.mlp1.b, self.mlp2.w,
                                self.mlp2.b, eps=ln2.eps, **gemm)
        w = (self.mlp1.wq, self.mlp1.wscale, self.mlp1.b, self.mlp2.wq, self.mlp2.wscale,
             self.mlp2.b)
        if plain:
            c = x.shape[-1]
            chunks = int8_tail_chunks(x.numel() // c, c, self.mlp1.wq.shape[1], self.tiled)
            return fused_ln_mlp_int8_plain(x, h, ln2.scale, ln2.bias, *w, eps=ln2.eps,
                                           chunks=chunks)
        tail = fused_ln_mlp_tiled_int8 if self.tiled else fused_ln_mlp_int8
        return tail(x, h, ln2.scale, ln2.bias, *w, eps=ln2.eps)

    def _tail_tp(self, x, h, tp, plain: bool):
        """A tensor-parallel shard's tail on the attention output h of its
        heads: the projection and mlp2 on the GEMM kernel without bias, each
        partial sum reduced over the group (:func:`_reduce`), then its bias
        and the residual; LN2 + mlp1 + GELU on the rank's columns. Two GEMMs
        around the reduce, as K4's single launch cannot take a partial sum;
        rounding where the single-card layer rounds (the projection's output,
        ``x + h``, the tail's output)."""
        gemm = gemm_plain if plain else gemm_bf16
        ln2, c = self.ln2, x.shape[-1]
        x = x + _reduce(tp, linear(h, self.proj.w, None, gemm=gemm), self.proj.b).to(x.dtype)
        hid = gemm(_copy(tp, x).reshape(-1, c).contiguous(), self.mlp1.w, self.mlp1.b,
                   ln=(ln2.scale, ln2.bias, ln2.eps), gelu=True)
        part = tp.reduce(gemm(hid, self.mlp2.w)).reshape(x.shape)
        return (x.float() + part + self.mlp2.b.float()).to(x.dtype)  # one rounding, as K4's


def _copy(tp, x):
    """Megatron's f in front of a column-parallel product (identity forward,
    the gradient summed over the group); x itself off tensor parallelism."""
    return x if tp is None else tp.copy(x)


def _reduce(tp, partial, bias):
    """A row-parallel product's partial sums reduced over the group in fp32
    (Megatron's g), plus the whole bias."""
    return tp.reduce(partial) + bias.float()


def _window_partition(x, ws: int):
    """(B, S, S, C) -> (B*nw*nw, ws, ws, C), zero-padded to a multiple of ws
    (JAX ``model.py:272-281``); also returns the padded side."""
    b, s, _, c = x.shape
    pad = (ws - s % ws) % ws
    if pad:
        x = F.pad(x, (0, 0, 0, pad, 0, pad))
    ps = s + pad
    nw = ps // ws
    x = x.reshape(b, nw, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nw * nw, ws, ws, c), ps


def _window_unpartition(win, ws: int, padded: int, orig: int):
    """Inverse of :func:`_window_partition`, cropped to ``orig``."""
    nw = padded // ws
    b, c = win.shape[0] // (nw * nw), win.shape[-1]
    x = win.reshape(b, nw, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, padded, padded, c)[:, :orig, :orig]


def _project(lin: nn.Module, x, plain: bool = False, gelu: bool = False, tp=None):
    """``x @ w + b`` (then GELU) for a float record on the GEMM kernel, or
    for an int8 one on ``int8_linear`` (JAX ``apply_linear``, then
    ``_gelu``). With ``tp`` the record is a row-parallel shard: its partial
    sums are reduced over the group before the bias."""
    if tp is not None:
        g = gemm_plain if plain else gemm_bf16
        return _reduce(tp, linear(x, lin.w, None, gemm=g), lin.b).to(x.dtype)
    if isinstance(lin, Int8Linear):
        fn = int8_linear_plain if plain else int8_linear
        return fn(x, lin.wq, lin.wscale, lin.b, gelu=gelu)
    return linear(x, lin.w, lin.b, **({"gemm": gemm_plain} if plain else {}), gelu=gelu)


def _vision_attention(layer: VisionLayer, h, heads: int, plain: bool = False, tp=None):
    """The flat route's attention (JAX ``_vision_attention``, ``:215-269``)
    on LayerNormed tokens h (B, S, S, C): a whole grid, or a batch of
    windows. qkv (float or int8) and the projection (float) on the GEMM
    kernels, the attention over all S x S tokens on K12 with grid side S.
    -> (B, S, S, C).

    Pad tokens of a partition are zero after LN1, so their qkv is the qkv
    bias: they stay keys, as in the JAX package. With ``tp`` the layer is a
    shard: the rank's heads, the projection reduced over the group."""
    o = relpos_grid_attention(_project(layer.qkv, _copy(tp, h), plain), layer.rel_pos_h,
                              layer.rel_pos_w, heads, plain)
    return _project(layer.proj, o, plain, tp=tp)


class SamImageEncoder(nn.Module):
    """ViT encoder. ``forward(pix)``: (B, H, W, 3) normalised ->
    (B, gs, gs, output_channels), on the grid route or the flat route
    (:meth:`grid_route`). ``conv2d_fused`` puts the neck's 3x3 on K17."""

    def __init__(self, p: Params, cfg: SamTPUConfig, conv2d_fused: bool = False):
        super().__init__()
        self.cfg = cfg
        self.conv2d_fused = conv2d_fused
        pw = np.asarray(p["patch_embed"]["w"])  # (ps, ps, 3, C) HWIO
        self.patch_w = _param(pw.reshape(-1, pw.shape[-1]))
        self.patch_b = _param(p["patch_embed"]["b"])
        self.pos_embed = _param(p["pos_embed"])
        self.layers = nn.ModuleList(VisionLayer(lp, cfg.layer_norm_eps) for lp in p["layers"])
        n = p["neck"]
        self.neck_conv1 = _param(n["conv1_w"])  # (C, oc)
        self.neck_ln1, self.neck_ln2 = Norm(n["ln1"], 1e-6), Norm(n["ln2"], 1e-6)
        w2 = np.asarray(n["conv2_w"])
        self.neck_conv2 = _param(w2 if conv2d_fused else w2.transpose(3, 2, 0, 1))  # HWIO, OIHW

    def grid_route(self) -> bool:
        """The JAX encoder's rule (``model.py:325-330``): the grid route when
        the window divides the grid, else the flat route. One exception, on
        every device: SAM's native window of 14 (``K12_WINDOW``), which
        divides the grids of the 224, 448 and 896 canvases but which the
        window attention kernel does not take (it takes ``KERNEL_WINDOWS``),
        sends those grids down the flat route, without padding. Both routes
        compute the same function."""
        s, ws = self.cfg.grid_size, self.cfg.window_size
        return s % ws == 0 and ws != K12_WINDOW

    def embed(self, pix: torch.Tensor, row0: int = 0) -> torch.Tensor:
        """Patch embedding + positional embedding of a block of whole patch
        rows (B, rows * ps, W, 3) that starts at patch row ``row0``."""
        ps = self.cfg.patch_size
        b, hgt, wid, ci = pix.shape
        gh, gw = hgt // ps, wid // ps
        patches = pix.reshape(b, gh, ps, gw, ps, ci).permute(0, 1, 3, 2, 4, 5)
        x = patches.reshape(b, gh, gw, ps * ps * ci) @ self.patch_w + self.patch_b
        return x + self.pos_embed[:, row0:row0 + gh]

    def neck(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        y = self.neck_ln1(x @ self.neck_conv1, plain)
        if self.conv2d_fused:  # zero bias: the kernel takes none
            y = (conv2d_act_plain if plain else conv2d_act)(y, self.neck_conv2, None, 3)
        else:
            y = F.conv2d(y.permute(0, 3, 1, 2), self.neck_conv2, padding=1)
            y = y.permute(0, 2, 3, 1).contiguous()
        return self.neck_ln2(y, plain)

    def forward(self, pix: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.neck(self.blocks(self.embed(pix), plain), plain)

    def blocks(self, x: torch.Tensor, plain: bool = False, first: int = 0,
               tp=None) -> torch.Tensor:
        """The layers on embedded tokens x (B, S, S, C), before the neck.
        ``self.layers[i]`` is the model's layer ``first + i`` (a pipeline
        stage holds a contiguous run of them, ``parallel/pp.py``); on the flat
        route the run hands on ``x + pending``, its last MLP residual added.
        ``tp`` (a ``parallel.tp.TPGroup``): the layers are the rank's shards of
        a tensor-parallel group (``parallel/tp.py``)."""
        cfg = self.cfg
        heads = cfg.vision_heads if tp is None else cfg.vision_heads // tp.size
        if not self.grid_route():
            return self._forward_flat(x, plain, first, heads, tp)
        for i, layer in enumerate(self.layers, first):
            window = cfg.grid_size if i in cfg.global_attn_indexes else cfg.window_size
            x = layer(x, heads, window, plain, tp)
        return x

    def _forward_flat(self, x: torch.Tensor, plain: bool, first: int = 0, heads=None,
                      tp=None) -> torch.Tensor:
        """The flat route's layers, in the JAX order (``model.py:420-461``):
        ``x, h = add_ln(ln1, x, pending)`` (the plain LN at layer 0), the
        attention (windowed layers on zero-padded partitions), ``x, h =
        add_ln(ln2, x, h)``, then mlp1 + GELU and mlp2 into ``pending``. The
        residual LayerNorms are K11d's call sites; qkv, mlp1 and mlp2 take
        float or int8 weights (:func:`_project`)."""
        cfg = self.cfg
        s, ws, heads = cfg.grid_size, cfg.window_size, heads or cfg.vision_heads
        ln = layer_norm_plain if plain else layer_norm
        pending = None  # the MLP residual, carried into the next LayerNorm
        for i, layer in enumerate(self.layers, first):
            l1, l2 = layer.ln1, layer.ln2
            if pending is None:
                h = ln(x, l1.scale, l1.bias, l1.eps)
            else:
                x, h = ln(x, l1.scale, l1.bias, l1.eps, residual=pending)
            if i in cfg.global_attn_indexes:
                h = _vision_attention(layer, h, heads, plain, tp)
            else:
                win, padded = _window_partition(h, ws)
                h = _window_unpartition(_vision_attention(layer, win, heads, plain, tp), ws,
                                        padded, s)
            x, h = ln(x, l2.scale, l2.bias, l2.eps, residual=h)
            h = _project(layer.mlp1, _copy(tp, h), plain, gelu=True)
            pending = _project(layer.mlp2, h, plain, tp=tp)
        return x if pending is None else x + pending


# --------------------------------------------------------------- prompt encoder


def _fourier_embed(pe_matrix: torch.Tensor, coords01: torch.Tensor) -> torch.Tensor:
    """Random-Fourier encoding of coords in [0, 1]^2 -> (..., 2*npf), in fp32
    and elementwise (sine arguments reach ~100 rad)."""
    c = (2.0 * coords01 - 1.0).float()
    pe = pe_matrix.float()
    proj = (2.0 * math.pi) * (c[..., 0:1] * pe[0] + c[..., 1:2] * pe[1])
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class SamPromptEncoder(nn.Module):
    """Box and point prompts and the decoder's dense positional encoding. The
    tree's ``shared_pe`` encodes the prompts and ``shared_image_pe``
    (``shared_pe`` where a tree has none) the image tokens: one matrix in
    SAM, two leaves in the JAX tree, which a fine-tune step updates apart."""

    def __init__(self, p: Params, shared_pe, cfg: SamTPUConfig, shared_image_pe=None):
        super().__init__()
        self.cfg = cfg
        self.point_embed = _param(p["point_embed"])
        self.not_a_point = _param(p["not_a_point"])
        self.no_mask = _param(p["no_mask"])
        self.shared_pe = _param(shared_pe)
        self.shared_image_pe = _param(shared_pe if shared_image_pe is None else shared_image_pe)

    def boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (B, K, 4) xyxy in encoder-input pixels -> (B, K, 2, C) fp32."""
        coords = (boxes + 0.5).reshape(*boxes.shape[:-1], 2, 2) / self.cfg.image_size
        emb = _fourier_embed(self.shared_pe, coords)
        pe = self.point_embed.float()
        return torch.stack([emb[..., 0, :] + pe[2], emb[..., 1, :] + pe[3]], dim=-2)

    def points(self, points: torch.Tensor, labels: torch.Tensor, pad: bool = True) -> torch.Tensor:
        """JAX ``sam_prompt_points``: points (B, K, P, 2) xy in encoder-input
        pixels, labels (B, K, P): 1 foreground, 0 background, -1 padding (the
        not-a-point embedding), and SAM 2's 2 and 3, a box's top-left and
        bottom-right corners (``point_embed`` 2 and 3, as :meth:`boxes` adds
        them) -> (B, K, P, C) fp32; ``pad`` appends one padding point (P + 1
        tokens), as SAM does for prompts without a box."""
        if pad:
            points = torch.cat([points, points.new_zeros(*points.shape[:-2], 1, 2)], dim=-2)
            labels = torch.cat([labels, labels.new_full((*labels.shape[:-1], 1), -1)], dim=-1)
        emb = _fourier_embed(self.shared_pe, (points + 0.5) / self.cfg.image_size)
        lab = labels[..., None]
        pe = self.point_embed.float()
        emb = torch.where(lab == -1, self.not_a_point.float(), emb)
        for i in range(4):
            emb = torch.where(lab == i, emb + pe[i], emb)
        return emb

    def image_pe(self) -> torch.Tensor:
        """Dense (gs, gs, C) positional encoding of the decoder's image tokens."""
        gs = self.cfg.grid_size
        t = (torch.arange(gs, dtype=torch.float32, device=self.shared_image_pe.device) + 0.5) / gs
        grid = torch.stack([t[None, :].expand(gs, gs), t[:, None].expand(gs, gs)], dim=-1)
        return _fourier_embed(self.shared_image_pe, grid)


# ----------------------------------------------------------------- mask decoder


def _softmax_fp32(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


class DecoderAttention(nn.Module):
    def __init__(self, p: Params):
        super().__init__()
        self.q, self.k, self.v, self.out = (Linear(p[n]) for n in ("q", "k", "v", "out"))

    def forward(self, q, k, v, heads: int):
        """SAM decoder attention on (N, T, C) inputs."""
        qp, kp, vp = self.q(q), self.k(k), self.v(v)
        n, tq, ci = qp.shape
        tk = kp.shape[1]
        hd = ci // heads
        qh = qp.reshape(n, tq, heads, hd).transpose(1, 2)
        kh = kp.reshape(n, tk, heads, hd).transpose(1, 2)
        vh = vp.reshape(n, tk, heads, hd).transpose(1, 2)
        attn = _softmax_fp32((qh * hd ** -0.5) @ kh.transpose(-1, -2)).to(vh.dtype)
        return self.out((attn @ vh).transpose(1, 2).reshape(n, tq, ci))

    def scaled_query(self, q, heads: int):
        """The query projection times hd^-0.5, as the fused decoder passes it."""
        qp = self.q(q)
        return qp * (qp.shape[-1] // heads) ** -0.5

    def next_t2i(self, qp):
        """The token-to-image operands :func:`i2t_keys_update` takes."""
        return {"qp": qp, "wk": self.k.w, "bk": self.k.b, "wv": self.v.w, "bv": self.v.b}


class DecoderLayer(nn.Module):
    def __init__(self, p: Params, eps: float):
        super().__init__()
        self.self_attn = DecoderAttention(p["self_attn"])
        self.t2i, self.i2t = DecoderAttention(p["t2i"]), DecoderAttention(p["i2t"])
        self.ln1, self.ln2, self.ln3, self.ln4 = (Norm(p[f"ln{i}"], eps) for i in range(1, 5))
        self.mlp1, self.mlp2 = Linear(p["mlp1"]), Linear(p["mlp2"])

    def mlp(self, x):
        return self.mlp2(torch.relu(self.mlp1(x)))


class FeedForward(nn.Module):
    """SAM FeedForward: relu MLP with proj_in / hidden layers / proj_out."""

    def __init__(self, p: Params):
        super().__init__()
        self.inp, self.out = Linear(p["in"]), Linear(p["out"])
        self.hidden = nn.ModuleList(Linear(lp) for lp in p["hidden"])

    def forward(self, x):
        x = torch.relu(self.inp(x))
        for lp in self.hidden:
            x = torch.relu(lp(x))
        return self.out(x)


def _conv_transpose_2x(x, w, b):
    """2x2 stride-2 transposed conv, NHWC; w (in_c, out_c, 2, 2) torch layout."""
    bsz, h, wd, _ = x.shape
    y = torch.einsum("bhwc,coij->bhiwjo", x, w)
    return y.reshape(bsz, h * 2, wd * 2, w.shape[1]) + b


class SamMaskDecoder(nn.Module):
    def __init__(self, p: Params, cfg: SamTPUConfig):
        super().__init__()
        self.cfg = cfg
        eps = cfg.decoder_layer_norm_eps
        self.iou_token, self.mask_tokens = _param(p["iou_token"]), _param(p["mask_tokens"])
        # SAM 2's object-score token, first among the output tokens where the
        # tree has one
        obj = p.get("obj_score_token")
        self.obj_score_token = None if obj is None else _param(obj)
        self.layers = nn.ModuleList(DecoderLayer(lp, eps) for lp in p["layers"])
        self.final_t2i = DecoderAttention(p["final_t2i"])
        self.ln_final = Norm(p["ln_final"], 1e-5)  # a default nn.LayerNorm in SAM
        self.up1_w, self.up1_b = _param(p["up1_w"]), _param(p["up1_b"])
        self.up_ln = Norm(p["up_ln"], 1e-6)
        self.up2_w, self.up2_b = _param(p["up2_w"]), _param(p["up2_b"])
        self.hyper_mlps = nn.ModuleList(FeedForward(fp) for fp in p["hyper_mlps"])
        self.iou_head = FeedForward(p["iou_head"])

    def tokens(self, image_embeddings, sparse_prompts, image_pe, dense_prompts,
               plain: bool = False):
        """Two-way transformer up to the mask upscaling.

        image_embeddings (B, gs, gs, C); sparse_prompts (B, K, P, C);
        image_pe (gs, gs, C); dense_prompts (B or 1, gs, gs, C), or the
        no-mask embedding (C,). Returns (iou (B, K, M),
        hyper (B*K, M, C/8), keys_grid (B*K, gs, gs, C)). ``plain`` runs the
        kernels' plain versions on any device (the fp32 oracle). A SAM 2
        decoder's object-score token leads the output tokens; nothing here
        reads its output.
        """
        cfg = self.cfg
        b, gs, _, c = image_embeddings.shape
        k = sparse_prompts.shape[1]
        heads = cfg.decoder_heads
        dt = image_embeddings.dtype
        img_flat = (image_embeddings + dense_prompts).reshape(b, gs * gs, c)
        img_pe = image_pe.reshape(1, gs * gs, c).to(dt)

        first = [] if self.obj_score_token is None else [self.obj_score_token]
        out_tokens = torch.cat([*first, self.iou_token, self.mask_tokens], dim=0)
        s = len(first)  # the IoU token's index
        num_out = out_tokens.shape[0]
        nt = num_out + sparse_prompts.shape[2]
        tokens = torch.cat(
            [out_tokens[None, None].expand(b, k, num_out, c), sparse_prompts], dim=2
        ).reshape(b * k, nt, c)
        queries = tokens
        point_pe = tokens

        # layer 0: the K prompts of an image share its image tokens, so the
        # t2i k/v projections run once per image (K6)
        t2i_fn = t2i_shared_attend_plain if plain else t2i_shared_attend
        i2t_fn = i2t_keys_update_plain if plain else i2t_keys_update
        l0 = self.layers[0]
        queries = l0.ln1(l0.self_attn(queries, queries, queries, heads), plain)
        qp = l0.t2i.scaled_query(queries + point_pe, heads)
        attn = t2i_fn(img_flat, img_pe, qp, l0.t2i.k.w, l0.t2i.k.b, l0.t2i.v.w, l0.t2i.v.b,
                      heads, k)
        queries = l0.ln2(queries + l0.t2i.out(attn), plain)
        queries = l0.ln3(queries + l0.mlp(queries), plain)

        # one pass over the keys stream per layer (K7): i2t + residual + LN4,
        # and the next token-to-image attention (layer i + 1's, or the final
        # one) from the new keys. Layer i + 1's self-attention and LN1 come
        # first, as in the JAX fused branch; i2t never reads them.
        keys_src, share = img_flat, k
        for i, lp in enumerate(self.layers):
            if i + 1 < len(self.layers):
                nxt = self.layers[i + 1]
                q = queries + point_pe
                q_pre = nxt.ln1(queries + nxt.self_attn(q, q, queries, heads), plain)
                t2i = nxt.t2i
            else:
                q_pre, t2i = queries, self.final_t2i
            i2t = lp.i2t
            keys, attn = i2t_fn(
                keys_src, img_pe, i2t.k(queries + point_pe), i2t.v(queries), i2t.q.w, i2t.q.b,
                i2t.out.w, i2t.out.b, lp.ln4.scale, lp.ln4.bias, heads=heads, k_share=share,
                eps=lp.ln4.eps, t2i=t2i.next_t2i(t2i.scaled_query(q_pre + point_pe, heads)),
            )
            attn = t2i.out(attn)
            if i + 1 < len(self.layers):
                queries = nxt.ln2(q_pre + attn, plain)
                queries = nxt.ln3(queries + nxt.mlp(queries), plain)
            else:
                queries = self.ln_final(q_pre + attn, plain)
            keys_src, share = keys, 1

        m = cfg.num_mask_tokens
        hyper = torch.stack(
            [self.hyper_mlps[i](queries[:, s + 1 + i, :]) for i in range(m)], dim=1
        )
        iou = self.iou_head(queries[:, s, :]).reshape(b, k, m)
        return iou, hyper, keys.reshape(b * k, gs, gs, c)

    def mask_head(self, keys_grid, hyper, plain: bool = False):
        """Upscale (N, g, g, C) tokens 4x and project with the hypernetwork
        outputs (N, M, C/8) -> fp32 logits (N, M, 4g, 4g)."""
        n, g, _, _ = keys_grid.shape
        up = _conv_transpose_2x(keys_grid, self.up1_w, self.up1_b)
        up = F.gelu(self.up_ln(up, plain))
        up = F.gelu(_conv_transpose_2x(up, self.up2_w, self.up2_b))
        hw4 = g * 4
        logits = torch.einsum("nmc,npc->nmp", hyper.float(), up.reshape(n, hw4 * hw4, -1).float())
        return logits.reshape(n, hyper.shape[1], hw4, hw4)


class SamModel(nn.Module):
    """Encoder + prompt encoder + mask decoder, built from one parameter tree.
    A MobileSAM tree (:func:`~.tinyvit.is_tinyvit`) gets the
    :class:`~.tinyvit.TinyViT` encoder, with ``tinyvit_mbconv_compute`` as
    its K14/K15 compute mode. ``conv2d_fused`` puts the encoder's dense convs
    on ``conv2d_act`` (K17)."""

    def __init__(self, params: Params, cfg: SamTPUConfig, conv2d_fused: bool = False,
                 tinyvit_mbconv_compute: str = "fp32"):
        super().__init__()
        self.cfg = cfg
        if is_tinyvit(params):
            tcfg = TinyViTConfig(image_size=cfg.image_size, output_channels=cfg.output_channels)
            self.vision = TinyViT(params["tinyvit"], tcfg, conv2d_fused, tinyvit_mbconv_compute)
        else:
            self.vision = SamImageEncoder(params["vision"], cfg, conv2d_fused)
        self.prompt = SamPromptEncoder(params["prompt"], params["shared_pe"], cfg,
                                       params.get("shared_image_pe"))
        self.decoder = SamMaskDecoder(params["decoder"], cfg)

    def forward_boxes(self, pixel_values, boxes, multimask_output: bool = False,
                      plain: bool = False, encode=None):
        """JAX ``sam_forward_boxes``: images (B, H, W, 3) normalised and boxes
        (B, K, 4) in encoder-input pixels -> :meth:`mask_decoder`'s (masks,
        IoU). ``encode`` replaces the encoder call (a parallel encoder over
        ``self.vision``); ``plain`` runs every kernel's plain version."""
        emb = self.vision(pixel_values, plain) if encode is None else encode(pixel_values)
        sparse = self.prompt.boxes(boxes).to(emb.dtype)
        return self.mask_decoder(emb, sparse, multimask_output=multimask_output, plain=plain)

    forward = forward_boxes  # the module call (the fine-tune step's functional_call)

    def encode(self, pix: torch.Tensor, mark=span) -> torch.Tensor:
        """The engine's embed call: (B, S, S, 3) normalised canvas pixels ->
        embeddings (B, gs, gs, C) fp32; no spans of its own to ``mark``."""
        return self.vision(pix).float()

    def box_prompts(self, boxes: torch.Tensor) -> torch.Tensor:
        """(B, K, 4) xyxy boxes in canvas pixels -> sparse prompts (B, K, 2, C)."""
        return self.prompt.boxes(boxes)

    def segment_windows(self, embeddings, boxes, windows, mark=span):
        """The engine's segment call: embeddings and box prompts (B, K, 4) in
        canvas pixels -> (token 0's logits sampled onto each prompt's crop
        (B*K, crop, crop) fp32, None: no token is chosen). The decoder runs in
        its weights' dtype, the mask head on each prompt's window of the keys
        grid (``windows``: ``ops.window_crop.crop_windows``)."""
        cd = self.prompt.no_mask.dtype
        sparse = self.box_prompts(boxes).to(cd)
        _, hyper, keys = self.mask_decoder_tokens(embeddings.to(cd), sparse)
        starts = windows.starts
        grid = window_crop(keys, starts[:, 0], starts[:, 1], windows.side)
        logits = self.decoder.mask_head(grid, hyper[:, :1, :])[:, 0]  # (B*K, 4 side, 4 side)
        return windows.sample(logits, starts * 4), None

    def mask_decoder(self, image_embeddings, sparse_prompts, dense_prompts=None,
                     multimask_output: bool = False, plain: bool = False):
        """JAX ``sam_mask_decoder``: embeddings (B, gs, gs, C), sparse prompts
        (B, K, P, C) and dense prompts (B or 1, gs, gs, C; None: the no-mask
        embedding) -> (low-res mask logits (B, K, M', 4gs, 4gs) fp32, IoU
        (B, K, M')): masks 1.. with ``multimask_output``, else mask 0. The
        mask head runs on the hypernetwork rows it returns."""
        b, gs = image_embeddings.shape[:2]
        k = sparse_prompts.shape[1]
        iou, hyper, keys = self.mask_decoder_tokens(image_embeddings, sparse_prompts,
                                                    dense_prompts, plain)
        sel = slice(1, None) if multimask_output else slice(0, 1)
        logits = self.decoder.mask_head(keys, hyper[:, sel], plain)
        return logits.reshape(b, k, -1, 4 * gs, 4 * gs), iou[:, :, sel]

    def mask_decoder_tokens(self, image_embeddings, sparse_prompts, dense_prompts=None,
                            plain: bool = False):
        """JAX ``sam_mask_decoder_tokens``; ``dense_prompts`` (B or 1, gs, gs,
        C), None for the no-mask embedding."""
        dense = self.prompt.no_mask if dense_prompts is None else dense_prompts
        return self.decoder.tokens(image_embeddings, sparse_prompts, self.prompt.image_pe(),
                                   dense.to(image_embeddings.dtype), plain)


# ------------------------------------------------------------------------- init


def init_sam_params(seed: int, cfg: SamTPUConfig) -> Params:
    """Random-init parameter tree, host numpy fp32. The same draws in the same
    order as the JAX package's ``init_sam_params``, so one seed gives
    identical weights in both."""
    nrng = np.random.default_rng(seed)
    dtype = np.float32

    def randn(*shape, scale=1.0):
        return nrng.normal(0.0, scale, size=shape).astype(dtype)

    def dense(i, o, scale=None):
        s = scale if scale is not None else (1.0 / math.sqrt(i))
        return {"w": randn(i, o, scale=s), "b": np.zeros((o,), dtype)}

    def ln(d):
        return {"scale": np.ones((d,), dtype), "bias": np.zeros((d,), dtype)}

    c = cfg.vision_hidden
    hd = c // cfg.vision_heads
    gs = cfg.grid_size

    def vis_layer(i):
        ws = cfg.window_size if i not in cfg.global_attn_indexes else gs
        return {
            "ln1": ln(c),
            "attn": {
                "qkv": dense(c, 3 * c),
                "proj": dense(c, c),
                "rel_pos_h": np.zeros((2 * ws - 1, hd), dtype),
                "rel_pos_w": np.zeros((2 * ws - 1, hd), dtype),
            },
            "ln2": ln(c),
            "mlp1": dense(c, cfg.vision_mlp_dim),
            "mlp2": dense(cfg.vision_mlp_dim, c),
        }

    oc = cfg.output_channels
    vision = {
        "patch_embed": {
            "w": (randn(cfg.patch_size, cfg.patch_size, 3, c) * 0.02).astype(dtype),
            "b": np.zeros((c,), dtype),
        },
        "pos_embed": np.zeros((1, gs, gs, c), dtype),
        "layers": [vis_layer(i) for i in range(cfg.vision_layers)],
        "neck": {
            "conv1_w": (randn(c, oc) * 0.02).astype(dtype),
            "ln1": ln(oc),
            "conv2_w": (randn(3, 3, oc, oc) * 0.02).astype(dtype),
            "ln2": ln(oc),
        },
    }

    ph = cfg.prompt_hidden
    prompt = {
        "point_embed": randn(4, ph) * 0.02,
        "not_a_point": randn(ph) * 0.02,
        "no_mask": randn(ph) * 0.02,
        "mask_embed": None,  # mask-prompt path unused by the pipeline
    }

    di = ph
    dh = di // 2

    def dec_attn(internal):
        return {
            "q": dense(di, internal),
            "k": dense(di, internal),
            "v": dense(di, internal),
            "out": dense(internal, di),
        }

    def dec_layer():
        return {
            "self_attn": dec_attn(di),
            "ln1": ln(di),
            "t2i": dec_attn(dh),
            "ln2": ln(di),
            "mlp1": dense(di, cfg.decoder_mlp_dim),
            "mlp2": dense(cfg.decoder_mlp_dim, di),
            "ln3": ln(di),
            "i2t": dec_attn(dh),
            "ln4": ln(di),
        }

    def ff(i, h, o, depth):
        return {
            "in": dense(i, h),
            "hidden": [dense(h, h) for _ in range(depth - 2)],
            "out": dense(h, o),
        }

    decoder = {
        "iou_token": randn(1, di) * 0.02,
        "mask_tokens": randn(cfg.num_mask_tokens, di) * 0.02,
        "layers": [dec_layer() for _ in range(cfg.decoder_layers)],
        "final_t2i": dec_attn(dh),
        "ln_final": ln(di),
        "up1_w": (randn(di, di // 4, 2, 2) * 0.02).astype(dtype),
        "up1_b": np.zeros((di // 4,), dtype),
        "up_ln": ln(di // 4),
        "up2_w": (randn(di // 4, di // 8, 2, 2) * 0.02).astype(dtype),
        "up2_b": np.zeros((di // 8,), dtype),
        "hyper_mlps": [ff(di, di, di // 8, 3) for _ in range(cfg.num_mask_tokens)],
        "iou_head": ff(di, cfg.iou_head_hidden, cfg.num_mask_tokens, cfg.iou_head_depth),
    }

    shared_pe = (randn(2, cfg.num_pos_feats) * (cfg.vision_hidden // 2)).astype(dtype)
    return {
        "vision": vision,
        "prompt": prompt,
        "decoder": decoder,
        "shared_pe": shared_pe,
        "shared_image_pe": shared_pe,
    }


__all__ = [
    "SamImageEncoder", "SamMaskDecoder", "SamModel", "SamPromptEncoder", "init_sam_params",
]
