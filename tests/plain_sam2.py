"""SAM 2's image path in plain fp32 PyTorch, after the published code: the
oracle the port's SAM 2 (``models/sam/hiera.py``) is held to on the CPU.

It follows ``sam2/modeling/backbones/hieradet.py`` (``Hiera``,
``MultiScaleBlock``, ``MultiScaleAttention``, ``PatchEmbed``),
``backbones/image_encoder.py`` (``ImageEncoder``, ``FpnNeck``),
``sam/prompt_encoder.py`` (``_embed_points``), ``sam/transformer.py``
(``TwoWayTransformer``), ``sam/mask_decoder.py`` (``predict_masks``,
``_dynamic_multimask_via_stability``) and ``sam2_base.py::forward_image`` /
``sam2_image_predictor.py::set_image`` (``conv_s0`` / ``conv_s1`` once an
image, ``no_mem_embed`` added to the embedding), in NCHW as they are. It
imports neither JAX nor the port. Departures:

* modules are functions of the tree that ``init_sam2_params`` draws (linear
  weights ``(in, out)``, the patch embedding HWIO, position tables ``(side,
  side, C)``), not ``nn.Module`` state dicts;
* the object-score head is not run: the image predictor gates no mask by it
  (its token is in the transformer, as published);
* the IoU head's sigmoid is applied after the choice: the argmax over tokens
  1.. is the same before and after it;
* a box enters as two points labelled 2 and 3 with the padding point, as the
  image predictor passes it (``boxes=None`` to the prompt encoder); no point
  or mask prompt.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Tree = Dict


def _ln(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


def _lin(x, p):
    return x @ p["w"] + p["b"]


def _conv1x1(x, p):
    """NCHW 1x1 conv of a linear record (in, out)."""
    return F.conv2d(x, p["w"].t()[:, :, None, None], p["b"])


# ------------------------------------------------------------------- trunk


def window_partition(x, ws):
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows, ws, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w].contiguous()


def _pool(x):
    """MaxPool2d(2, 2) of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def attention(x, p, heads, pool):
    """MultiScaleAttention on (B, H, W, dim) -> (B, H', W', dim_out)."""
    b, h, w, _ = x.shape
    qkv = _lin(x, p["qkv"]).reshape(b, h * w, 3, heads, -1)
    q, k, v = torch.unbind(qkv, 2)
    if pool:
        q = _pool(q.reshape(b, h, w, -1))
        h, w = q.shape[1:3]
        q = q.reshape(b, h * w, heads, -1)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), -1)
    return _lin((a @ v).transpose(1, 2).reshape(b, h, w, -1), p["proj"])


def block(x, p, dim, dim_out, heads, window, pool, eps=1e-6):
    """MultiScaleBlock on (B, H, W, dim)."""
    shortcut = x
    x = _ln(x, p["ln1"], eps)
    if dim != dim_out:
        shortcut = _lin(x, p["shortcut"])
        if pool:
            shortcut = _pool(shortcut)
    h, w = x.shape[1:3]
    if window > 0:
        x, pad_hw = window_partition(x, window)
    x = attention(x, p, heads, pool)
    if pool:
        ws = window // 2
        h, w = shortcut.shape[1:3]
        pad_hw = (h + (ws - h % ws) % ws, w + (ws - w % ws) % ws)
    else:
        ws = window
    if window > 0:
        x = window_unpartition(x, ws, pad_hw, (h, w))
    x = shortcut + x
    m = F.gelu(_lin(_ln(x, p["ln2"], eps), p["mlp1"]))
    return x + _lin(m, p["mlp2"])


def pos_embed(v, side):
    """``Hiera._get_pos_embed`` for a side x side grid -> (1, side, side, C)."""
    pe = F.interpolate(v["pos_embed"].permute(2, 0, 1)[None], size=(side, side), mode="bicubic")
    win = v["pos_embed_window"].permute(2, 0, 1)[None]
    pe = pe + win.tile([a // b for a, b in zip(pe.shape, win.shape)])
    return pe.permute(0, 2, 3, 1)


def trunk(v, cfg, pix) -> List[torch.Tensor]:
    """Hiera on (B, 3, H, W) -> each stage's output (B, H_i, W_i, C_i)."""
    w = v["patch_embed"]["w"].permute(3, 2, 0, 1)
    x = F.conv2d(pix, w, v["patch_embed"]["b"], stride=cfg.patch_stride,
                 padding=cfg.patch_kernel // 2).permute(0, 2, 3, 1)
    x = x + pos_embed(v, x.shape[1])
    outs = []
    for i, (p, spec) in enumerate(zip(v["blocks"], cfg.blocks())):
        x = block(x, p, *spec, eps=cfg.layer_norm_eps)
        if i in cfg.stage_ends:
            outs.append(x)
    return outs


def neck(v, cfg, xs):
    """FpnNeck (1x1 laterals, nearest top-down sums), the scalp, then
    ``forward_image``'s conv_s0 / conv_s1 and ``set_image``'s no_mem_embed
    -> (embedding, feat_s1, feat_s0), NCHW."""
    n = len(xs) - 1
    out = [None] * len(xs)
    prev = None
    for i in range(n, -1, -1):
        lateral = _conv1x1(xs[i].permute(0, 3, 1, 2), v["neck"]["lateral"][i])
        if i in cfg.fpn_top_down_levels and prev is not None:
            prev = lateral + F.interpolate(prev, scale_factor=2.0, mode="nearest")
        else:
            prev = lateral
        out[i] = prev
    feats = out[:len(out) - cfg.scalp]
    emb = feats[-1] + v["no_mem_embed"][None, :, None, None]
    return (emb, _conv1x1(feats[1], v["neck"]["conv_s1"]),
            _conv1x1(feats[0], v["neck"]["conv_s0"]))


def encode(tree, cfg, pix_nhwc):
    """(B, H, W, 3) normalised pixels -> (embedding, feat_s1, feat_s0) NCHW."""
    return neck(tree["vision"], cfg, trunk(tree["vision"], cfg, pix_nhwc.permute(0, 3, 1, 2)))


# ---------------------------------------------------------- prompts, decoder


def _pe(gauss, coords01):
    c = 2.0 * coords01 - 1.0
    c = 2.0 * math.pi * (c @ gauss)
    return torch.cat([torch.sin(c), torch.cos(c)], -1)


def embed_boxes(tree, cfg, boxes):
    """``_embed_points`` of each box's corners, labels 2 and 3, padded with a
    not-a-point: (N, 4) canvas pixels -> (N, 3, C)."""
    n = boxes.shape[0]
    pts = torch.cat([boxes.reshape(n, 2, 2) + 0.5, torch.zeros(n, 1, 2)], 1)
    labels = torch.tensor([2, 3, -1]).expand(n, 3)
    emb = _pe(tree["shared_pe"], pts / cfg.image_size)
    pr = tree["prompt"]
    emb = torch.where((labels == -1)[..., None], pr["not_a_point"], emb)
    for i in range(4):
        emb = torch.where((labels == i)[..., None], emb + pr["point_embed"][i], emb)
    return emb


def dense_pe(tree, gs):
    """``get_dense_pe``: (1, C, gs, gs)."""
    t = (torch.arange(gs, dtype=torch.float32) + 0.5) / gs
    grid = torch.stack([t[None, :].expand(gs, gs), t[:, None].expand(gs, gs)], -1)
    return _pe(tree["shared_image_pe"], grid).permute(2, 0, 1)[None]


def _attn(p, q, k, v, heads):
    q, k, v = _lin(q, p["q"]), _lin(k, p["k"]), _lin(v, p["v"])
    n, tq, d = q.shape
    sp = lambda t: t.reshape(n, t.shape[1], heads, d // heads).transpose(1, 2)  # noqa: E731
    a = torch.softmax(sp(q) @ sp(k).transpose(-1, -2) / math.sqrt(d // heads), -1)
    return _lin((a @ sp(v)).transpose(1, 2).reshape(n, tq, d), p["out"])


def two_way(d, cfg, src, pos, tokens):
    """TwoWayTransformer: src (N, C, g, g), pos (N, C, g, g), tokens (N, T, C)."""
    eps, heads = cfg.decoder_layer_norm_eps, cfg.decoder_heads
    keys = src.flatten(2).permute(0, 2, 1)
    kpe = pos.flatten(2).permute(0, 2, 1)
    queries = tokens
    for i, lp in enumerate(d["layers"]):
        if i == 0:
            queries = _attn(lp["self_attn"], queries, queries, queries, heads)
        else:
            q = queries + tokens
            queries = queries + _attn(lp["self_attn"], q, q, queries, heads)
        queries = _ln(queries, lp["ln1"], eps)
        q, k = queries + tokens, keys + kpe
        queries = _ln(queries + _attn(lp["t2i"], q, k, keys, heads), lp["ln2"], eps)
        mlp = _lin(torch.relu(_lin(queries, lp["mlp1"])), lp["mlp2"])
        queries = _ln(queries + mlp, lp["ln3"], eps)
        q, k = queries + tokens, keys + kpe
        keys = _ln(keys + _attn(lp["i2t"], k, q, queries, heads), lp["ln4"], eps)
    q, k = queries + tokens, keys + kpe
    queries = _ln(queries + _attn(d["final_t2i"], q, k, keys, heads), d["ln_final"], 1e-5)
    return queries, keys


def _mlp(p, x):
    x = torch.relu(_lin(x, p["in"]))
    for h in p["hidden"]:
        x = torch.relu(_lin(x, h))
    return _lin(x, p["out"])


def _ln2d(x, p, eps=1e-6):
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + eps)
    return p["scale"][:, None, None] * x + p["bias"][:, None, None]


def predict_masks(tree, cfg, emb, feat_s1, feat_s0, sparse):
    """``predict_masks`` for N prompts, each on its own image's features
    (N, C, g, g), (N, C/4, 2g, 2g), (N, C/8, 4g, 4g) -> (masks (N, M, 4g,
    4g), iou (N, M) before the sigmoid)."""
    d = tree["decoder"]
    n = sparse.shape[0]
    out = torch.cat([d["obj_score_token"], d["iou_token"], d["mask_tokens"]], 0)
    tokens = torch.cat([out[None].expand(n, -1, -1), sparse], 1)
    src = emb + tree["prompt"]["no_mask"][None, :, None, None]
    pos = dense_pe(tree, emb.shape[-1]).expand(n, -1, -1, -1)
    hs, keys = two_way(d, cfg, src, pos, tokens)
    b, c, h, w = src.shape
    src = keys.transpose(1, 2).reshape(b, c, h, w)
    up = F.gelu(_ln2d(F.conv_transpose2d(src, d["up1_w"], d["up1_b"], stride=2) + feat_s1,
                      d["up_ln"]))
    up = F.gelu(F.conv_transpose2d(up, d["up2_w"], d["up2_b"], stride=2) + feat_s0)
    m = cfg.num_mask_tokens
    hyper = torch.stack([_mlp(d["hyper_mlps"][i], hs[:, 2 + i]) for i in range(m)], 1)
    b, c, h, w = up.shape
    masks = (hyper @ up.view(b, c, h * w)).view(b, -1, h, w)
    return masks, _mlp(d["iou_head"], hs[:, 1])


def stability(logits, delta):
    logits = logits.flatten(-2)
    area_i = torch.sum(logits > delta, -1).float()
    area_u = torch.sum(logits > -delta, -1).float()
    return torch.where(area_u > 0, area_i / area_u, 1.0)


def single_mask(cfg, masks, iou) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_dynamic_multimask_via_stability`` -> (mask (N, 4g, 4g), token (N,),
    iou (N,) after the sigmoid)."""
    best = torch.argmax(iou[:, 1:], -1)
    idx = torch.arange(iou.shape[0])
    stable = stability(masks[:, 0], cfg.stability_delta) >= cfg.stability_thresh
    token = torch.where(stable, torch.zeros_like(best), best + 1)
    return masks[idx, token], token, torch.sigmoid(iou[idx, token])


def segment(tree, cfg, feats, boxes):
    """Box prompts (B, K, 4) in canvas pixels on each image's features ->
    (low-res masks (B, K, 4g, 4g), token (B, K), iou (B, K))."""
    emb, s1, s0 = feats
    b, k = boxes.shape[:2]
    rep = lambda t: t.repeat_interleave(k, 0)  # noqa: E731
    masks, iou = predict_masks(tree, cfg, rep(emb), rep(s1), rep(s0),
                               embed_boxes(tree, cfg, boxes.reshape(b * k, 4)))
    mask, token, score = single_mask(cfg, masks, iou)
    return (mask.reshape(b, k, *mask.shape[-2:]), token.reshape(b, k), score.reshape(b, k))
