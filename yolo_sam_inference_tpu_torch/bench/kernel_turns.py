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
per image) at T 196, 784, 1024 and 4096; ``fused_ln_matmul`` (K1) and
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
768, beside ``F.layer_norm`` with its weights cast beforehand. Beside each
K12 and LayerNorm time, the device time of the kernels of the call. Prints
the card, then one ``[TAG] name: ms`` line per call. Needs one card.
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
    args = ap.parse_args()
    common = _own_common()
    sys.path.insert(0, args.tree)

    import torch

    from yolo_sam_inference_tpu_torch.ops import conv2d_fused as tcv
    from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
    from yolo_sam_inference_tpu_torch.ops import dw_ln_mlp as tdw
    from yolo_sam_inference_tpu_torch.ops import flash_attention as tfa
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln

    assert tln.__file__.startswith(args.tree), tln.__file__
    median_ms, device_ms = common.median_ms, common.device_ms
    print(common.card(), flush=True)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to("cuda")

    def say(name, fn, kernel=None):
        for _ in range(200):  # a busy card first: its clocks ramp up from idle
            fn()
        torch.cuda.synchronize()
        ms = median_ms(fn)
        dev = "" if kernel is None else device_ms(fn, kernel)
        dev = "" if kernel is None else (", device not measured" if dev is None
                                         else f", device {dev:.4f}")
        print(f"[{args.tag}] {name}: {ms:.4f}{dev}", flush=True)

    b, k, tq = 32, 16, 7
    qp = rn(b * k, tq, 128, std=0.25).to(bf)
    for t in (196, 784, 1024, 4096):
        kp, vp = rn(b, t, 128).to(bf), rn(b, t, 128).to(bf)
        say(f"t2i_attend T{t}", lambda: dec.t2i_attend(qp, kp, vp, 8, k))
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


if __name__ == "__main__":
    main()
