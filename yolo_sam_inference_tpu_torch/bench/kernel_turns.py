"""Time PR-comparable kernel calls of one checkout's port, for runs in turns.

    python yolo_sam_inference_tpu_torch/bench/kernel_turns.py --tree DIR --tag NAME

Imports ``yolo_sam_inference_tpu_torch`` from the checkout at DIR (its
kernels build into DIR/build/), so the same script times two trees: run it
for the parent, the change, the change and the parent, each in its own
process, and compare the medians. The timing helpers and the shapes come
from this script's own checkout, so both trees are timed by the same code.
It times, on batch-32 inputs made from seed 0 (CUDA events, median of 20
calls, after 200 calls that bring the card's clocks up from idle):
``t2i_attend`` (K6, 32 images x 16 prompts x 7 tokens, k/v shared
per image) at T 196, 784, 1024 and 4096; ``keys_stream`` (K7's pass: the
layer-1 pass of 512 streams at T 784, 1024 and 4096, layer 0's at T 1024
with 16 prompts sharing each of 32 images' keys; K6's k/v projection pass
of 32 images) and ``t2i_combine`` on the layer-1 pass's partials; the
three at T 1024 at the prompt-token counts of point prompts, tq 9, 16, 17
and 34 (a tree whose kernels take at most 8 tokens prints "refused");
``mbconv_block`` (K14) at TinyViT-5M's stage 0 (32 x 128 x 128 x 64, E 256)
and merge2 (32 x 32 x 32 x 160, E 320, Co 320) in both compute modes;
``patch_merge_block`` (K15) at merge0 and merge1 (``MERGE_SHAPES``) in both
compute modes; ``tinyvit_window_block`` (K13), the whole block, at the three
``TINYVIT_STAGES`` (its device time: every kernel of the call), and where
the tree has the first design's attention kernel, that kernel alone on a
random qkv; ``fused_ln_matmul`` (K1) and
``fused_ln_mlp`` (K4 at ViT-B, K10 at ViT-L and ViT-H) at 32768 rows;
``conv2d_act`` (K17) at every ``CONV_SHAPES`` row; ``dw_conv3x3`` (K16's
depthwise) at the three TinyViT stages, with ``ln=`` where the tree's
wrapper takes it (one pass writing y and LN(y)), else y alone. Beside each
K17 and K16 time, the kernel's device time from ``torch.profiler``; and
K16's whole tail (``dw_ln_mlp``) at the three stages; K12
(``flash_attention_relpos``) at its three shapes (a sequence-parallel
rank's share of ViT-H's 64 x 64 global layer, ViT-B's 40 x 40 global layer
and 14 x 14 windows of the 640 canvas), the kernel alone on q, k and v
views with the raw rel-pos tables, and at the flat shapes the route the
path runs around it (``relpos_grid_attention``, fused qkv in, output out);
the LayerNorm (K5) at the neck's 32768 x 256, the mask head's 991232 x 64
and the decoder's 3584 x 256 rows and its residual form (K11d) at 51200 x
768, beside ``F.layer_norm`` with its weights cast beforehand; the window
attention (K3, ``window_attention``) at windows 16 and 32 of the 32 x 32
grid at hd 64 (ViT-B) and hd 80 (ViT-H) and at the 48 x 48 and 64 x 64
grids' global layers; the w8a8
functions (K11a at ViT-L, K11b at ViT-H, K11c at both, 32768 rows) and
``int8_linear`` at the flat route's 51200 rows (qkv, mlp1 + GELU, mlp2),
with the bare int8 products on ``torch._int_mm`` beside them; K8
(``window_crop``) at config 1 (512 windows of 11 x 11 on 32 x 32 grids) and
config 4 (7 x 7 on 64 x 64), 256 channels, the starts as the engine passes
them, also with the L2 flushed before each call (``common.after_l2_flush``); K9 on 128 x 128 ellipse crops (``common.ellipse_masks``) at config
1's 512 cells and the classical batch's 95: the kernel alone, the metrics'
masks-to-support-points call (``_hull_vertices``), the candidates' plain
front end, and config 1's whole ``metrics_stage``; K9 on one whole-frame
mask of 2048, 4096 and 8192 a side (a tree that refuses the side prints
"refused"). Beside each K7, K14,
K15, K13, K12, LayerNorm, K3, w8a8, K8 and K9 time, the device time of the
kernels of the call and their count a call. Prints the card, then one
``[TAG] name: ms`` line per call. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import sys
from pathlib import Path


def _own_common():
    """This checkout's bench/common.py, whichever tree is being timed."""
    spec = importlib.util.spec_from_file_location("_turns_common",
                                                  Path(__file__).with_name("common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the checkout whose port to time")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--only", default="",
                    help="comma-separated name prefixes of the calls to time (default: all)")
    args = ap.parse_args()
    only = tuple(filter(None, args.only.split(",")))
    common = _own_common()
    sys.path.insert(0, args.tree)

    import torch

    from yolo_sam_inference_tpu_torch.ops import conv2d_fused as tcv
    from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
    from yolo_sam_inference_tpu_torch.ops import dw_ln_mlp as tdw
    from yolo_sam_inference_tpu_torch.ops import flash_attention as tfa
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops import quant as tquant

    assert tln.__file__.startswith(args.tree), tln.__file__
    median_ms, device_ms_count = common.median_ms, common.device_ms_count
    print(common.card(), flush=True)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to("cuda")

    def say(name, fn, kernel=None):
        if only and not name.strip().startswith(only):
            return
        for _ in range(200):  # a busy card first: its clocks ramp up from idle
            fn()
        torch.cuda.synchronize()
        ms = median_ms(fn)
        dev, nk = (None, None) if kernel is None else device_ms_count(fn, kernel)
        dev = "" if kernel is None else (", device not measured" if dev is None
                                         else f", device {dev:.4f} ({nk} kernels a call)")
        print(f"[{args.tag}] {name}: {ms:.4f}{dev}", flush=True)

    b, k, tq = 32, 16, 7
    _crop_and_hull(say, rn, g, common, b, k)
    qp = rn(b * k, tq, 128, std=0.25).to(bf)
    for t in (196, 784, 1024, 4096):
        kp, vp = rn(b, t, 128).to(bf), rn(b, t, 128).to(bf)
        say(f"t2i_attend T{t}", lambda: dec.t2i_attend(qp, kp, vp, 8, k))

    # K7 (keys_stream with i2t, then t2i_combine) and K6's projection pass
    # (keys_stream without i2t) at config 1's decoder widths
    c, dh, n = 256, 128, b * k
    wq, wk, wv = (rn(c, dh, std=c ** -0.5).to(bf) for _ in range(3))
    wo = rn(dh, c, std=dh ** -0.5).to(bf)
    bq, bk, bv, bo = rn(dh, std=0.1), rn(dh, std=0.1), rn(dh, std=0.1), rn(c, std=0.1)
    kq, vq, qn = rn(n, tq, dh).to(bf), rn(n, tq, dh).to(bf), rn(n, tq, dh, std=0.25).to(bf)
    i2t = (kq, vq, wq, bq, wo, bo, 1.0 + rn(c, std=0.1), rn(c, std=0.1))
    kv = (wk, bk, wv, bv)
    for t in (784, 1024, 4096):
        pe, keys = rn(t, c).to(bf), rn(n, t, c).to(bf)
        say(f"keys_stream layer 1 T{t} (512 streams)",
            lambda: dec.keys_stream(keys, pe, *kv, qn=qn, i2t=i2t), "keys_stream")
        if t == 1024:
            img = rn(b, t, c).to(bf)
            say("keys_stream layer 0 T1024 (32 images x 16 prompts)",
                lambda: dec.keys_stream(img, pe, *kv, k_share=k, qn=qn, i2t=i2t), "keys_stream")
            say("keys_stream k/v projection T1024 (32 images)",
                lambda: dec.keys_stream(img, pe, *kv), "keys_stream")
            part = dec.keys_stream(keys, pe, *kv, qn=qn, i2t=i2t)[1]
            say(f"t2i_combine T1024 (512 streams x {part.shape[1]} tiles)",
                lambda: dec.t2i_combine(part, tq), "t2i_combine")
            del img, part
        del pe, keys
        torch.cuda.empty_cache()

    # point prompts' token counts (5 + P + 1), as next queries too
    pe, keys = rn(1024, c).to(bf), rn(n, 1024, c).to(bf)
    kp, vp = rn(b, 1024, dh).to(bf), rn(b, 1024, dh).to(bf)
    for m in (9, 16, 17, 34):
        qn_m = rn(n, m, dh, std=0.25).to(bf)
        i2t_m = (rn(n, m, dh).to(bf), rn(n, m, dh).to(bf), *i2t[2:])
        try:
            part = dec.keys_stream(keys, pe, *kv, qn=qn_m, i2t=i2t_m)[1]
        except ValueError as e:
            print(f"[{args.tag}] keys_stream tq{m}: refused ({e})", flush=True)
            continue
        say(f"keys_stream layer 1 T1024 tq{m} (512 streams)",
            lambda: dec.keys_stream(keys, pe, *kv, qn=qn_m, i2t=i2t_m), "keys_stream")
        say(f"t2i_combine T1024 tq{m} (512 streams x {part.shape[1]} tiles)",
            lambda: dec.t2i_combine(part, m), "t2i_combine")
        say(f"t2i_attend T1024 tq{m}", lambda: dec.t2i_attend(qn_m, kp, vp, 8, k))
    del pe, keys, kp, vp
    torch.cuda.empty_cache()

    # K14 (mbconv_block, stride 1): TinyViT-5M's stage 0 and its merge2 on the
    # 512 canvas, in both compute modes
    from yolo_sam_inference_tpu_torch.ops import mbconv_fused as tmb

    for label, (side, ci, e, co, res) in (("stage0", (128, 64, 256, 64, True)),
                                          ("merge2", (32, 160, 320, 320, False))):
        x = rn(b, side, side, ci).to(bf)
        w = (rn(ci, e, std=ci ** -0.5).to(bf), rn(e, std=0.3), rn(3, 3, e, std=1 / 3).to(bf),
             rn(e, std=0.3), rn(e, co, std=e ** -0.5).to(bf), rn(co, std=0.3))
        for mode in ("fp32", "bf16"):
            say(f"mbconv {label} {mode}",
                lambda: tmb.mbconv_block(x, *w, residual=res, compute=mode), "mbconv")
        del x
        torch.cuda.empty_cache()
    # K15 (patch_merge_block, stride 2): merge0 and merge1 on the 512 canvas,
    # in both compute modes
    for label, (hh, ww, ci), e, co in common.MERGE_SHAPES:
        x = rn(b, hh, ww, ci).to(bf)
        w = (rn(ci, e, std=ci ** -0.5).to(bf), rn(e, std=0.3), rn(3, 3, e, std=1 / 3).to(bf),
             rn(e, std=0.3), rn(e, co, std=e ** -0.5).to(bf), rn(co, std=0.3))
        for mode in ("fp32", "bf16"):
            say(f"patch_merge {label} {mode}",
                lambda: tmb.patch_merge_block(x, *w, compute=mode), "mbconv")
        del x
        torch.cuda.empty_cache()

    # K13 (tinyvit_window_block): the whole block, x + proj(attn(LN(pad(x)))),
    # at TinyViT-5M's three stages (every kernel of the call on the device),
    # and, where the tree has it, the first design's attention kernel alone
    from yolo_sam_inference_tpu_torch.ops import tinyvit_attention as ttv

    attn = getattr(ttv, "tinyvit_attention", None)
    for si, gs, c, heads, ws in common.TINYVIT_STAGES:
        x = rn(b, gs, gs, c).to(bf)
        table = rn(heads, (2 * ws - 1) ** 2, std=0.5).to(bf)
        ln_s, ln_b = (1.0 + rn(c, std=0.1)).to(bf), rn(c, std=0.5).to(bf)
        wq, bq = rn(c, 3 * c, std=c ** -0.5).to(bf), rn(3 * c, std=0.3).to(bf)
        wp, bp = rn(c, c, std=c ** -0.5).to(bf), rn(c, std=0.1).to(bf)
        blk = (table, ln_s, ln_b, wq, bq, wp, bp, heads, ws)
        say(f"tinyvit_block stage{si} ws{ws}", lambda: ttv.tinyvit_window_block(x, *blk), "")
        if attn is not None:
            qkv = rn(b, gs, gs, 3 * c).to(bf)
            pad = ttv.pad_qkv_row(ln_b, wq, bq, bf)
            say(f"tinyvit_attn stage{si} ws{ws} (attention alone)",
                lambda: attn(qkv, pad, table, heads, ws), "tinyvit_attn")
            del qkv
        del x
        torch.cuda.empty_cache()

    m = 32 * 1024
    for name, c in (("ViT-B", 768), ("ViT-L", 1024), ("ViT-H", 1280)):
        x, h = rn(m, c).to(bf), rn(m, c).to(bf)
        s, bb = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        wq, bq = rn(c, 3 * c, std=c ** -0.5).to(bf), rn(3 * c, std=0.1)
        w1, b1 = rn(c, 4 * c, std=c ** -0.5).to(bf), rn(4 * c, std=0.1)
        w2, b2 = rn(4 * c, c, std=(4 * c) ** -0.5).to(bf), rn(c, std=0.1)
        say(f"K1 {name}", lambda: tln.fused_ln_matmul(x, s, bb, wq, bq))
        say(f"{'K4' if c == 768 else 'K10'} {name}",
            lambda: tln.fused_ln_mlp(x, h, s, bb, w1, b1, w2, b2))
        del x, h, wq, w1, w2
        torch.cuda.empty_cache()

    for key, (hh, ww, ci), co, kk, stride, act, has_bias, sliced in common.CONV_SHAPES:
        x = rn(b, hh, ww, 2 * ci).to(bf)[..., ci:] if sliced else rn(b, hh, ww, ci).to(bf)
        wt = rn(kk, kk, ci, co, std=(kk * kk * ci) ** -0.5).to(bf)
        bias = rn(co, std=0.3) if has_bias else None
        say(f"conv2d_act {key}", lambda: tcv.conv2d_act(x, wt, bias, kk, stride, act),
            "conv2d_act")
        del x, wt
        torch.cuda.empty_cache()

    with_ln = "ln" in inspect.signature(tdw.dw_conv3x3).parameters
    for si, gs, c in common.DW_STAGES:
        x = rn(b, gs, gs, c).to(bf)
        wd, bd = rn(3, 3, c, std=1 / 3).to(bf), rn(c, std=0.3)
        ln = (1.0 + rn(c, std=0.1), rn(c, std=0.1), 1e-5)
        fn = (lambda: tdw.dw_conv3x3(x, wd, bd, ln=ln)) if with_ln else (
            lambda: tdw.dw_conv3x3(x, wd, bd))
        say(f"dw_conv3x3 stage{si} ({'y and LN(y)' if with_ln else 'y'})", fn, "dw3x3")
        if with_ln:
            say(f"dw_conv3x3 stage{si} (y)", lambda: tdw.dw_conv3x3(x, wd, bd), "dw3x3")
        w1, b1 = rn(c, 4 * c, std=c ** -0.5).to(bf), rn(4 * c, std=0.1)
        w2, b2 = rn(4 * c, c, std=(4 * c) ** -0.5).to(bf), rn(c, std=0.1)
        say(f"K16 tail stage{si}", lambda: tdw.dw_ln_mlp(x, wd, bd, ln[0], ln[1], w1, b1, w2, b2))
        del x

    # K12: (label, images, heads, hd, grid side, query rows, first row)
    for label, bi, heads, hd, s, rows, row0 in (
            ("sp ViT-H rank 1 of 2", 32, 16, 80, 64, 32, 32),
            ("flat ViT-B global 40x40", 32, 12, 64, 40, 40, 0),
            ("flat ViT-B windows 14x14", 32 * 9, 12, 64, 14, 14, 0)):
        c, n, nq = heads * hd, s * s, rows * s
        rel_h, rel_w = rn(2 * s - 1, hd, std=0.3).to(bf), rn(2 * s - 1, hd, std=0.3).to(bf)
        own = rn(bi, nq, 3 * c).to(bf)  # the rank's qkv, or the whole grid's
        kv = rn(bi, n, 2 * c).to(bf) if row0 else own[..., c:]
        q, k, v = own[..., :c], kv[..., :c], kv[..., c:2 * c]
        say(f"K12 kernel {label}",
            lambda: tfa.flash_attention_relpos(q, k, v, rel_h, rel_w, s, row0=row0),
            "flash_attn_relpos")
        if rows == s:  # a whole grid: the path's call is relpos_grid_attention
            qkv = own.reshape(bi, s, s, 3 * c)
            say(f"K12 route {label}", lambda: tfa.relpos_grid_attention(qkv, rel_h, rel_w, heads),
                "")
        del own, kv, q, k, v
        torch.cuda.empty_cache()

    # K5 and K11d: (label, rows, C, residual)
    for label, rows, c, res in (("neck 32768x256", 32768, 256, False),
                                ("up_ln 991232x64", 991232, 64, False),
                                ("decoder 3584x256", 3584, 256, False),
                                ("K11d 51200x768", 51200, 768, True)):
        x = rn(rows, c).to(bf)
        r = rn(rows, c).to(bf) if res else None
        sc, sh = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        sc16, sh16 = sc.to(bf), sh.to(bf)
        say(f"layer_norm {label}", lambda: tln.layer_norm(x, sc, sh, 1e-6, residual=r), "")
        say(f"F.layer_norm {label} (x alone)",
            lambda: torch.nn.functional.layer_norm(x, (c,), sc16, sh16, 1e-6), "")
        del x, r


    # K3: (label, images, heads, hd, grid side, window)
    for label, bi, heads, hd, s, win in (("ViT-B w16", 32, 12, 64, 32, 16),
                                         ("ViT-B w32", 32, 12, 64, 32, 32),
                                         ("ViT-H w16", 32, 16, 80, 32, 16),
                                         ("ViT-H w32", 32, 16, 80, 32, 32),
                                         ("ViT-B w48 (768 canvas)", 32, 12, 64, 48, 48),
                                         ("ViT-H w48", 32, 16, 80, 48, 48),
                                         ("ViT-B w64", 32, 12, 64, 64, 64),
                                         ("ViT-H w64 (config 4)", 32, 16, 80, 64, 64)):
        qkv = rn(bi, s, s, 3 * heads * hd).to(bf)
        rel_h, rel_w = rn(2 * win - 1, hd, std=0.3).to(bf), rn(2 * win - 1, hd, std=0.3).to(bf)
        say(f"K3 {label}", lambda: tfa.window_attention(qkv, rel_h, rel_w, heads, win), "")
        del qkv
        torch.cuda.empty_cache()

    # the w8a8 functions: K11c, K11a / K11b at 32768 rows, int8_linear at 51200
    def int8_weight(i, o):
        return tquant.quantize_weight(rn(i, o, std=i ** -0.5))

    def int_mm(rows, i, wq):  # the bare int8 product, the library yardstick
        xq = torch.randint(-127, 128, (rows, i), generator=g, dtype=torch.int8).cuda()
        try:
            torch._int_mm(xq, wq)
        except RuntimeError:  # a build that takes the weight only column-major
            wq = wq.t().contiguous().t()
        say(f"torch._int_mm {rows}x{i} @ {i}x{wq.shape[1]}", lambda: torch._int_mm(xq, wq))

    for name, c, tiled in (("ViT-L", 1024, False), ("ViT-H", 1280, True)):
        x, h = rn(m, c).to(bf), rn(m, c).to(bf)
        s, bb = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        wq, ws = int8_weight(c, 3 * c)
        bq = rn(3 * c, std=0.1)
        (w1q, w1s), (w2q, w2s) = int8_weight(c, 4 * c), int8_weight(4 * c, c)
        b1, b2 = rn(4 * c, std=0.1), rn(c, std=0.1)
        say(f"K11c {name}", lambda: tln.fused_ln_matmul_int8(x, s, bb, wq, ws, bq), "")
        int_mm(m, c, wq)
        tail = tln.fused_ln_mlp_tiled_int8 if tiled else tln.fused_ln_mlp_int8
        say(f"{'K11b' if tiled else 'K11a'} {name}",
            lambda: tail(x, h, s, bb, w1q, w1s, b1, w2q, w2s, b2), "")
        int_mm(m, c, w1q)
        int_mm(m, 4 * c, w2q)
        del x, h
        torch.cuda.empty_cache()
    rows = 32 * 1600
    for label, ci, co, gelu in (("qkv", 768, 2304, False), ("mlp1", 768, 3072, True),
                                ("mlp2", 3072, 768, False)):
        x = rn(rows, ci).to(bf)
        wq, ws = int8_weight(ci, co)
        bb = rn(co, std=0.1)
        say(f"int8_linear {label} {rows}x{ci} -> {co}",
            lambda: tln.int8_linear(x, wq, ws, bb, gelu=gelu), "")
        int_mm(rows, ci, wq)
        del x



def _crop_and_hull(say, rn, g, common, b: int, k: int) -> None:
    """K8 at config 1 (gs 32, wg 11) and config 4 (gs 64, wg 7): ``b * k``
    prompts' windows of 256 channels, the starts as the engine passes them
    (the two columns of its (N, 2) int64 tensor); then K9 and the metrics
    stage around it."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.ops import hull_support as thull
    from yolo_sam_inference_tpu_torch.ops import metrics as tmet
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop
    from yolo_sam_inference_tpu_torch.pipeline import engine as teng

    bf = torch.bfloat16
    for label, gs, wg in (("config 1", 32, 11), ("config 4", 64, 7)):
        grid = rn(b * k, gs, gs, 256).to(bf)
        starts = torch.randint(0, gs - wg + 1, (b * k, 2), generator=g).cuda()
        crop = lambda: window_crop(grid, starts[:, 0], starts[:, 1], wg)
        say(f"window_crop {label} gs{gs} wg{wg}", crop, "window_crop")
        say(f"window_crop {label} gs{gs} wg{wg} (every kernel of the call)", crop, "")
        say(f"window_crop {label} gs{gs} wg{wg} (L2 flushed before each call; events time the "
            f"flush too)", common.after_l2_flush(crop), "window_crop")
        del grid
    # K9 (hull support) on 128 x 128 ellipse crops: config 1's 512 cells and
    # the classical batch's 95; the kernel alone (a tree with the points form
    # takes candidates made beforehand), the masks-to-points call of the
    # metrics (_hull_vertices: the candidates' front end and K9 in the
    # parent), the front end alone where the tree has it, and config 1's
    # whole metrics stage (16 metrics of 32 x 16 crops)
    dirs = torch.from_numpy(tmet._hull_directions(256)).cuda()
    rng = np.random.default_rng(1)
    for label, cells in (("config 1", b * k), ("classical batch", 95)):
        masks = torch.from_numpy(common.ellipse_masks(rng, cells, 128)).cuda()
        if hasattr(thull, "support_points"):  # the points form
            pts = tmet._hull_candidates(masks)[0]
            kernel = lambda: thull.support_points(pts, dirs)
        else:
            kernel = lambda: thull.hull_support(masks, dirs)
        say(f"hull_support {label} ({cells} cells, kernel alone)", kernel, "hull_support")
        say(f"hull_vertices {label} ({cells} cells, masks to points)",
            lambda: tmet._hull_vertices(masks, 256), "")
        cands = getattr(thull, "hull_candidates", getattr(tmet, "_hull_candidates", None))
        say(f"hull_candidates {label} ({cells} cells, the front end)", lambda: cands(masks), "")
    # K9 on one whole frame (the single-cell API's mask): a centred ellipse
    # with semi-axes 0.45 of the side; a tree that refuses the side prints
    # "refused"
    for side in (2048, 4096, 8192):
        yy, xx = torch.meshgrid(torch.arange(side, device="cuda"),
                                torch.arange(side, device="cuda"), indexing="ij")
        frame = (((yy - side / 2) / (0.45 * side)) ** 2
                 + ((xx - side / 2) / (0.45 * side)) ** 2 <= 1)[None]
        del yy, xx
        try:
            thull.hull_support(frame, dirs)
        except ValueError:
            print(f"hull_support frame {side}: refused", flush=True)
            continue
        say(f"hull_support frame {side} (one {side} x {side} mask)",
            lambda: thull.hull_support(frame, dirs), "hull_support")
    crops = torch.from_numpy(common.ellipse_masks(rng, b * k, 128)).cuda().reshape(b, k, 128, 128)
    offsets = torch.randint(0, 512 - 128 + 1, (b, k, 2), generator=g).cuda()
    gray = (torch.rand(b, 512, 512, generator=g) * 255).cuda()
    opts = teng.PipelineOptions(batch_size=b, max_det=k)
    say(f"metrics_stage config 1 ({b} x {k} crops of 128, 16 metrics)",
        lambda: teng.metrics_stage(crops, offsets, gray, (512, 512), opts), "")


if __name__ == "__main__":
    main()
