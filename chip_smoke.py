#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one or more lines each; any
failure ends the run with a non-zero exit and no result line:

1. environment: torch / CUDA versions and the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit``); fails without a CUDA device;
2. build: compiles ``yolo_sam_inference_tpu_torch/csrc/*.cu`` with nvcc into
   ``build/kernels/<hash>/`` and prints the seconds;
   and each kernel's registers and spills as ``-Xptxas -v`` gives them;
3. kernels: each hand-written kernel against its plain PyTorch version in
   fp32 (TF32 off) on the same inputs, at the config-1 main path's batch-32
   shapes, with the stated bound; then each kernel's median time beside the
   plain version's (and beside bf16 torch, for context);
4. slice: the config-1 pipeline (YOLOv8n + SAM ViT-B, 512x512 uint8 frames,
   bf16, random weights from seed 0): one batch of 8 with every kernel's
   launch count checked, the bf16 image embedding of one frame against the
   fp32 plain path on the same card, the bf16 decoder on that frame's prompts
   against the fp32 plain decoder, and a timed pass at batch 32;
5. big kernels: the kernels of the ViT-L/H paths at their batch-32 shapes:
   ``gemm_bf16`` at the ViT-L/H qkv and MLP (K10) widths and the attention at
   hd 80 against fp32 plain versions, and the w8a8 kernels (K11c, K11a,
   K11b) against their plain int8 versions on the same bf16 inputs;
6. big slices: ``facebook/sam-vit-large`` (max_det 50, frames with 40 cells:
   config 3's multi-box traffic) and ``facebook/sam-vit-huge`` (max_det 16),
   each in bf16 and with ``quant="int8"`` from one parameter tree: a batch of
   8 with every launch count checked, the image embedding of one frame
   against the fp32 plain encoder on the same bf16-rounded float weights,
   and a timed pass at batch 32;
7. result: the kernel table as one JSON line, then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SLICE_BATCH = 8
TIMED_BATCH = 32
TIMED_ITERS = 3
FRAME = 512
KERNEL_ROWS = TIMED_BATCH * 1024  # B * 32 * 32 tokens at config 1
# the ViT-L/H paths: (model type, max_det, layers, C, heads, MLP hidden)
BIG_MODELS = (("facebook/sam-vit-large", 50, 24, 1024, 16, 4096),
              ("facebook/sam-vit-huge", 16, 32, 1280, 16, 5120))
BIG_CELLS = 40  # cells per frame in the big slices (config 3: 10-50 per image)


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _ptxas_summary(log: str) -> list:
    """One line per kernel from ``-Xptxas -v``: registers and spill bytes."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f", spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"ptxas {name}: {m.group(1)} registers{spill}")
            name = None
    return lines


def _check(name: str, got, ref, rtol: float, results: dict) -> float:
    """max |got - ref| must stay within rtol * max |ref| (bf16 kernel vs fp32)."""
    import torch

    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    bound = rtol * max(scale, 1e-6)
    ok = bool(torch.isfinite(got.float()).all()) and err <= bound
    _say("kernels", f"{name}: max_abs_err={err:.6g} bound={bound:.6g} (max|ref|={scale:.6g}, "
                    f"rtol={rtol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    kernel = name.split()[0]
    results[kernel] = max(results.get(kernel, 0.0), err)
    return err


def _check_int8(name: str, got, ref, results: dict) -> float:
    """An int8 kernel against its plain int8 version on the same bf16 inputs.

    Both round the same exact integer products to bf16, so most elements
    agree to the last bit. An LN or hidden value that lies on an int8
    rounding boundary may resolve the other way after a last-bit difference
    upstream (the fp32 LN statistics are summed in another order) and move
    its whole row by one quantisation step (tests/test_quant.py:197-208). So:
    rows with an element beyond one bf16 step of the row's largest value
    (2^-7 of it) must be at most 10% of the rows, and no element may be off
    by more than 2% of the output range (the bf16 products' bound)."""
    import torch

    d = (got.float() - ref.float()).abs()
    scale = ref.float().abs().max().item()
    row_tol = ref.float().abs().amax(-1, keepdim=True) * 2 ** -7
    bad_rows = (d > row_tol).any(-1).float().mean().item()
    err = d.max().item()
    ok = bool(torch.isfinite(got.float()).all()) and bad_rows <= 0.1 and err <= 2e-2 * scale
    _say("kernels", f"{name}: max_abs_err={err:.6g} (bound {2e-2 * scale:.6g}), rows off by more "
                    f"than a bf16 step {bad_rows:.4f} (bound 0.1) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: int8 kernel disagrees with its plain version")
    kernel = name.split()[0]
    results[kernel] = max(results.get(kernel, 0.0), err)
    return err


def _kernel_phase(card: str) -> dict:
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.ops.flash_attention import (
        window_attention,
        window_attention_plain,
    )
    from yolo_sam_inference_tpu_torch.ops.fused_ln import (
        fused_ln_matmul,
        fused_ln_mlp,
        gemm_bf16,
        gemm_plain,
        layer_norm,
        layer_norm_plain,
        linear,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    bf = torch.bfloat16
    m, c, hidden, heads = KERNEL_ROWS, 768, 3072, 12
    x = randn(m, c).to(bf)
    h = randn(m, c).to(bf)
    ln_s, ln_b = 1.0 + randn(c, std=0.1), randn(c, std=0.1)
    w_qkv, b_qkv = randn(c, 3 * c, std=c ** -0.5).to(bf), randn(3 * c, std=0.1)
    w_proj, b_proj = randn(c, c, std=c ** -0.5).to(bf), randn(c, std=0.1)
    w1, b1 = randn(c, hidden, std=c ** -0.5).to(bf), randn(hidden, std=0.1)
    w2, b2 = randn(hidden, c, std=hidden ** -0.5).to(bf), randn(c, std=0.1)
    xf, hf = x.float(), h.float()
    errs: dict = {}  # kernel -> largest max_abs_err over its cases
    times: dict = {}  # kernel -> (kernel ms, plain ms on the same bf16 inputs[, torch bf16 ms])

    # gemm_bf16: K1 (LN1 + qkv), the attention projection, K4 (two launches)
    k1 = lambda: fused_ln_matmul(x, ln_s, ln_b, w_qkv, b_qkv)
    k1p = lambda: fused_ln_matmul(x, ln_s, ln_b, w_qkv, b_qkv, gemm=gemm_plain)
    ref = fused_ln_matmul(xf, ln_s, ln_b, w_qkv, b_qkv, gemm=gemm_plain)
    _check("gemm_bf16 K1 ln+qkv (32768x768 @ 768x2304)", k1(), ref, 2e-2, errs)
    pr = lambda: linear(h, w_proj, b_proj)
    _check("gemm_bf16 attn proj (32768x768 @ 768x768)", pr(),
           linear(hf, w_proj, b_proj, gemm=gemm_plain), 2e-2, errs)
    k4 = lambda: fused_ln_mlp(x, h, ln_s, ln_b, w1, b1, w2, b2)
    k4p = lambda: fused_ln_mlp(x, h, ln_s, ln_b, w1, b1, w2, b2, gemm=gemm_plain)
    _check("gemm_bf16 K4 ln+mlp (two launches, hidden 3072)", k4(),
           fused_ln_mlp(xf, hf, ln_s, ln_b, w1, b1, w2, b2, gemm=gemm_plain), 2e-2, errs)
    # ragged M/N/K edges, decoder-like row count (B*K*7 = 32*16*7)
    xr, wr, br = randn(3584, 264).to(bf), randn(264, 136, std=0.06).to(bf), randn(136)
    _check("gemm_bf16 ragged (3584x264 @ 264x136, ln+gelu)",
           gemm_bf16(xr, wr, br, ln=(torch.ones(264, device=dev), torch.zeros(264, device=dev),
                                     1e-6), gelu=True),
           gemm_plain(xr.float(), wr, br, ln=(torch.ones(264, device=dev),
                                      torch.zeros(264, device=dev), 1e-6), gelu=True),
           2e-2, errs)
    bf16_k1 = lambda: torch.addmm(b_qkv.to(bf), x, w_qkv)
    times["gemm_bf16"] = (median_ms(k1), median_ms(k1p), median_ms(bf16_k1))
    _say("kernels", f"gemm_bf16 K1 shape: kernel {times['gemm_bf16'][0]:.4f} ms, plain "
                    f"{times['gemm_bf16'][1]:.4f} ms, torch bf16 addmm (no LN) "
                    f"{times['gemm_bf16'][2]:.4f} ms [{card}]")
    t_k4 = (median_ms(k4), median_ms(k4p))
    _say("kernels", f"gemm_bf16 K4 (2 launches): kernel {t_k4[0]:.4f} ms, plain "
                    f"{t_k4[1]:.4f} ms [{card}]")

    # window_attn_relpos: K2 + K3 at window 16 (8 layers) and 32 (4 global layers)
    b_att = TIMED_BATCH
    for window, std_qk, label in ((16, 1.0, "w16"), (32, 1.0, "w32"),
                                  (16, 3.2, "w16 |s|~30"), (32, 3.2, "w32 |s|~30")):
        qkv = randn(b_att, 32, 32, 3 * c).to(bf)
        qkv[..., :2 * c] *= std_qk
        rel_h = randn(2 * window - 1, 64, std=0.3).to(bf)  # bf16, as the pipeline's weights
        rel_w = randn(2 * window - 1, 64, std=0.3).to(bf)
        fn = lambda: window_attention(qkv, rel_h, rel_w, heads, window)
        fnp = lambda: window_attention_plain(qkv, rel_h, rel_w, heads, window)
        if std_qk > 1.0:
            q = qkv[..., :c].float().reshape(b_att, 32, 32, heads, 64)
            kk = qkv[..., c:2 * c].float().reshape(b_att, 32, 32, heads, 64)
            s_max = (q[:, :window, :window] * 0.125 * kk[:, :1, :1]).sum(-1).abs().max().item()
            _say("kernels", f"attention {label}: sampled max |q.k/8| = {s_max:.1f}")
        _check(f"window_attn_relpos {label} ({b_att}x32x32x2304)", fn(),
               window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2, errs)
        if std_qk == 1.0:
            times[f"attn_{label}"] = (median_ms(fn), median_ms(fnp, reps=5))
            _say("kernels", f"window_attn_relpos {label}: kernel {times[f'attn_{label}'][0]:.4f} "
                            f"ms, plain {times[f'attn_{label}'][1]:.4f} ms [{card}]")

    # layer_norm (Triton): neck rows at C=256, mask-head rows at C=64, residual form
    for rows, cc, res, label in ((KERNEL_ROWS, 256, False, "neck 32768x256"),
                                 (32 * 16 * 44 * 44, 64, False, "up_ln 991232x64"),
                                 (32 * 16 * 7, 256, True, "add+ln 3584x256")):
        xl = randn(rows, cc).to(bf)
        rl = randn(rows, cc).to(bf) if res else None
        sl, bl = 1.0 + randn(cc, std=0.1), randn(cc, std=0.1)
        got = layer_norm(xl, sl, bl, 1e-6, residual=rl)
        ref = layer_norm_plain(xl.float(), sl, bl, 1e-6,
                               residual=None if rl is None else rl.float())
        if res:
            _check(f"layer_norm {label} (sum)", got[0], ref[0], 1e-2, errs)
            got, ref = got[1], ref[1]
        _check(f"layer_norm {label}", got, ref, 1e-2, errs)
        if label.startswith("neck"):
            fn = lambda: layer_norm(xl, sl, bl, 1e-6)
            fnp = lambda: layer_norm_plain(xl, sl, bl, 1e-6)
            bf16_ln = lambda: torch.nn.functional.layer_norm(xl, (cc,), sl.to(bf), bl.to(bf), 1e-6)
            times["layer_norm"] = (median_ms(fn), median_ms(fnp), median_ms(bf16_ln))
            _say("kernels", f"layer_norm neck: kernel {times['layer_norm'][0]:.4f} ms, plain "
                            f"{times['layer_norm'][1]:.4f} ms, F.layer_norm bf16 "
                            f"{times['layer_norm'][2]:.4f} ms [{card}]")
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "t_k4": t_k4}


def _decoder_kernel_phase(card: str) -> dict:
    """The decoder, crop and hull kernels at the config-1 batch-32 shapes:
    B*K = 512 prompt streams of 1024 tokens x 256 channels, 7 prompt tokens,
    8 heads of 16; an 11 x 11 crop of the 32 x 32 grid; 512 candidates x 256
    directions per cell."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
    from yolo_sam_inference_tpu_torch.ops.hull_support import support_points, support_points_plain
    from yolo_sam_inference_tpu_torch.ops.metrics import _hull_candidates, _hull_directions
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop, window_crop_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(1)

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    b, k, t, c, dh, tq = TIMED_BATCH, 16, 1024, 256, 128, 7
    n = b * k
    w = {name: randn(c, dh, std=c ** -0.5) for name in ("wq", "wk", "wv")}
    w["wo"] = randn(dh, c, std=dh ** -0.5)
    bq, bk, bv, bo = (randn(m, std=0.1, dtype=torch.float32) for m in (dh, dh, dh, c))
    ln_s, ln_b = 1.0 + randn(c, std=0.1, dtype=torch.float32), randn(c, std=0.1, dtype=torch.float32)
    pe, img, keys = randn(t, c), randn(b, t, c), randn(n, t, c)
    kv = (w["wk"], bk, w["wv"], bv)
    errs: dict = {}
    times: dict = {}

    # keys_stream: the i2t pass of layer 0 (per-image keys shared by 16
    # prompts) and layer 1, each with the next attention split over the tiles
    # and joined by t2i_combine (K7); and K6's per-image projection pass
    qn = randn(n, tq, dh, std=0.25)  # next queries, already scaled by hd^-0.5
    nxt = {"wk": w["wk"], "bk": bk, "wv": w["wv"], "bv": bv}
    w_i2t = (w["wq"], bq, w["wo"], bo, ln_s, ln_b)
    kq, vq = randn(n, tq, dh), randn(n, tq, dh)

    def i2t(src, share):
        return lambda: dec.i2t_keys_update(src, pe, kq, vq, *w_i2t, heads=8, k_share=share,
                                           t2i={"qp": qn, **nxt})

    def i2t_ref(src, share):
        return lambda: dec.i2t_keys_update_plain(
            src.float(), pe.float(), kq.float(), vq.float(), *w_i2t, heads=8, k_share=share,
            t2i={"qp": qn.float(), **nxt})

    runs = {
        "i2t layer 0 (32 images x 16 prompts)": (i2t(img, k), i2t_ref(img, k), ("keys", "attn")),
        "i2t layer 1 (512 streams)": (i2t(keys, 1), i2t_ref(keys, 1), ("keys", "attn")),
        "k/v projection (32 images)": (
            lambda: dec.kv_project(img, pe, *kv, 8),
            lambda: dec.kv_project_plain(img.float(), pe.float(), *kv), ("kp", "vp")),
    }
    for label, (fn, ref, parts) in runs.items():
        for got, want, part in zip(fn(), ref(), parts):
            _check(f"keys_stream {label}: {part}", got, want, 2e-2, errs)
        times[f"keys_stream {label}"] = (median_ms(fn), median_ms(ref, reps=3, warmup=1))
    # the layer-1 pass alone, without its combine (beside the whole plain function)
    pass1 = lambda: dec.keys_stream(keys, pe, *kv, qn=qn, i2t=(kq, vq, *w_i2t))
    times["keys_stream layer 1 pass alone"] = (
        median_ms(pass1), times["keys_stream i2t layer 1 (512 streams)"][1])
    part = pass1()[1]  # layer 1's partials
    fn, ref = lambda: dec.t2i_combine(part, tq), lambda: dec.t2i_combine_plain(part, tq)
    _check("t2i_combine (512 streams x 16 tiles)", fn(), ref(), 2e-2, errs)
    times["t2i_combine"] = (median_ms(fn), median_ms(ref))
    # t2i_attend: layer 0's per-image k/v shared by 16 prompts (K6)
    qp = randn(n, tq, dh, std=0.25)
    kp_, vp_ = randn(b, t, dh), randn(b, t, dh)
    fn = lambda: dec.t2i_attend(qp, kp_, vp_, 8, k)
    ref = lambda: dec.t2i_attend_plain(qp.float(), kp_.float(), vp_.float(), 8, k)
    _check("t2i_attend shared (k_share 16)", fn(), ref(), 2e-2, errs)
    times["t2i_attend"] = (median_ms(fn), median_ms(ref, reps=5))
    # window_crop: a copy, exact
    grid = randn(n, 32, 32, c)
    r0, c0 = (torch.randint(0, 32 - 11 + 1, (n,), generator=g).to(dev) for _ in range(2))
    fn, ref = lambda: window_crop(grid, r0, c0, 11), lambda: window_crop_plain(grid, r0, c0, 11)
    _check("window_crop (512x32x32x256 -> 11x11)", fn(), ref(), 0.0, errs)
    times["window_crop"] = (median_ms(fn), median_ms(ref))
    # hull_support: candidates of elliptical 128 x 128 masks, exact
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:128, :128]
    cy, cx, ry, rx = (rng.uniform(lo, hi, size=(n, 1, 1)) for lo, hi in
                      ((40, 88), (40, 88), (8, 40), (8, 40)))
    masks = torch.from_numpy(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).to(dev)
    pts, _ = _hull_candidates(masks)
    dirs = torch.from_numpy(_hull_directions(256)).to(dev)
    fn, ref = lambda: support_points(pts, dirs), lambda: support_points_plain(pts, dirs)
    _check(f"hull_support ({n} cells x {pts.shape[1]} candidates x 256 directions)", fn(), ref(),
           0.0, errs)
    times["hull_support"] = (median_ms(fn), median_ms(ref))
    for name, (ms, plain) in times.items():
        _say("kernels", f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]")
    torch.cuda.synchronize()
    return {"errs": errs, "times": times}


def _big_kernel_phase(card: str) -> dict:
    """The kernels of the ViT-L/H paths at their batch-32 shapes
    (32768 rows): K1 and K10 on gemm_bf16, the attention at hd 80, and the
    w8a8 kernels K11c, K11a (ViT-L) and K11b (ViT-H)."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.models.sam.model import RESIDENT_MLP_INT8_MAX
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops.flash_attention import (
        window_attention,
        window_attention_plain,
    )
    from yolo_sam_inference_tpu_torch.ops.quant import quantize_weight

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(2)

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to(dev)

    m = KERNEL_ROWS
    errs: dict = {}
    times: dict = {}
    for model, _, _, c, heads, hidden in BIG_MODELS:
        tag = "ViT-L" if c == 1024 else "ViT-H"
        x, h = randn(m, c).to(bf), randn(m, c).to(bf)
        ln_s, ln_b = 1.0 + randn(c, std=0.1), randn(c, std=0.1)
        # weights as the pipeline holds them: bf16, and int8 from the bf16 values
        w_qkv, b_qkv = randn(c, 3 * c, std=c ** -0.5).to(bf), randn(3 * c, std=0.1).to(bf)
        w1, b1 = randn(c, hidden, std=c ** -0.5).to(bf), randn(hidden, std=0.1).to(bf)
        w2, b2 = randn(hidden, c, std=hidden ** -0.5).to(bf), randn(c, std=0.1).to(bf)
        (q_qkv, s_qkv), (q1, s1), (q2, s2) = (quantize_weight(w) for w in (w_qkv, w1, w2))
        xf, hf = x.float(), h.float()

        # K1 and K10 (K4's function, fused_ln_mlp) on gemm_bf16 against fp32
        # plain versions
        k1 = lambda: tln.fused_ln_matmul(x, ln_s, ln_b, w_qkv, b_qkv)
        k1p = lambda: tln.fused_ln_matmul(x, ln_s, ln_b, w_qkv, b_qkv, gemm=tln.gemm_plain)
        _check(f"gemm_bf16 K1 {tag} ln+qkv ({m}x{c} @ {c}x{3 * c})", k1(),
               tln.fused_ln_matmul(xf, ln_s, ln_b, w_qkv, b_qkv, gemm=tln.gemm_plain), 2e-2, errs)
        k10 = lambda: tln.fused_ln_mlp(x, h, ln_s, ln_b, w1, b1, w2, b2)
        k10p = lambda: tln.fused_ln_mlp(x, h, ln_s, ln_b, w1, b1, w2, b2, gemm=tln.gemm_plain)
        _check(f"gemm_bf16 K10 {tag} ln+mlp ({c}->{hidden}->{c}, two launches)", k10(),
               tln.fused_ln_mlp(xf, hf, ln_s, ln_b, w1, b1, w2, b2, gemm=tln.gemm_plain),
               2e-2, errs)
        times[f"K1 {tag}"] = (median_ms(k1), median_ms(k1p, reps=5))
        times[f"K10 {tag}"] = (median_ms(k10), median_ms(k10p, reps=5))

        # w8a8 against the plain int8 versions on the same bf16 inputs
        k11c = lambda: tln.fused_ln_matmul_int8(x, ln_s, ln_b, q_qkv, s_qkv, b_qkv)
        k11cp = lambda: tln.fused_ln_matmul_int8_plain(x, ln_s, ln_b, q_qkv, s_qkv, b_qkv)
        _check_int8(f"fused_ln_matmul_int8 K11c {tag} ({m}x{c} -> {3 * c})", k11c(), k11cp(), errs)
        times[f"K11c {tag}"] = (median_ms(k11c), median_ms(k11cp, reps=5))
        tiled = c * hidden > RESIDENT_MLP_INT8_MAX
        name = "fused_ln_mlp_tiled_int8 K11b" if tiled else "fused_ln_mlp_int8 K11a"
        tail = tln.fused_ln_mlp_tiled_int8 if tiled else tln.fused_ln_mlp_int8
        chunks = tln.int8_tail_chunks(m, c, hidden, tiled)
        k11 = lambda: tail(x, h, ln_s, ln_b, q1, s1, b1, q2, s2, b2)
        k11p = lambda: tln.fused_ln_mlp_int8_plain(x, h, ln_s, ln_b, q1, s1, b1, q2, s2, b2,
                                                   chunks=chunks)
        _check_int8(f"{name} {tag} ({c}->{hidden}->{c}, {chunks} chunks)", k11(), k11p(), errs)
        times[name.split()[1] + f" {tag}"] = (median_ms(k11), median_ms(k11p, reps=5))
        for key in (f"K1 {tag}", f"K11c {tag}", f"K10 {tag}", f"{name.split()[1]} {tag}"):
            _say("kernels", f"{key}: kernel {times[key][0]:.4f} ms, plain {times[key][1]:.4f} ms "
                            f"[{card}]")
        del x, h, w_qkv, w1, w2, q_qkv, q1, q2, xf, hf
        torch.cuda.empty_cache()

    # window_attn_relpos at hd 80 (ViT-H: 16 heads of 80): windows 16 and 32,
    # and with |q.k / sqrt(80)| ~ 30
    c, heads, hd = 1280, 16, 80
    for window, std_qk, label in ((16, 1.0, "hd80 w16"), (32, 1.0, "hd80 w32"),
                                  (16, 2.8, "hd80 w16 |s|~30"), (32, 2.8, "hd80 w32 |s|~30")):
        qkv = randn(TIMED_BATCH, 32, 32, 3 * c).to(bf)
        qkv[..., :2 * c] *= std_qk
        rel_h, rel_w = (randn(2 * window - 1, hd, std=0.3).to(bf) for _ in range(2))
        fn = lambda: window_attention(qkv, rel_h, rel_w, heads, window)
        fnp = lambda: window_attention_plain(qkv, rel_h, rel_w, heads, window)
        if std_qk > 1.0:
            q = qkv[..., :c].float().reshape(TIMED_BATCH, 32, 32, heads, hd)
            kk = qkv[..., c:2 * c].float().reshape(TIMED_BATCH, 32, 32, heads, hd)
            s_max = (q[:, :window, :window] * hd ** -0.5 * kk[:, :1, :1]).sum(-1).abs().max().item()
            _say("kernels", f"attention {label}: sampled max |q.k/sqrt(80)| = {s_max:.1f}")
        _check(f"window_attn_relpos {label} ({TIMED_BATCH}x32x32x{3 * c})", fn(),
               window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2, errs)
        if std_qk == 1.0:
            times[f"attn {label}"] = (median_ms(fn), median_ms(fnp, reps=5))
            _say("kernels", f"window_attn_relpos {label}: kernel {times[f'attn {label}'][0]:.4f} "
                            f"ms, plain {times[f'attn {label}'][1]:.4f} ms [{card}]")
        del qkv
    torch.cuda.synchronize()
    return {"errs": errs, "times": times}


def _slice_phase(card: str) -> dict:
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.ops.decoder_fused import keys_stream, t2i_attend, t2i_combine
    from yolo_sam_inference_tpu_torch.ops.flash_attention import window_attention
    from yolo_sam_inference_tpu_torch.ops.fused_ln import gemm_bf16, layer_norm
    from yolo_sam_inference_tpu_torch.ops.hull_support import support_points
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
    from yolo_sam_inference_tpu_torch.ops.preprocess import sam_preprocess_batch
    from yolo_sam_inference_tpu_torch.pipeline.engine import (
        CellSegmentationPipeline,
        PipelineOptions,
    )
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    t0 = time.perf_counter()
    opts = PipelineOptions(max_det=16, metric_crop=128)
    pipe = CellSegmentationPipeline(
        sam_model_type="facebook/sam-vit-base", options=opts, device="cuda", seed=0
    )
    pipe._stages(FRAME, FRAME)
    _say("slice", f"pipeline built (ViT-B init + adapt + upload): {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    frames = cell_frames(rng, TIMED_BATCH, FRAME)

    wrappers = {"gemm_bf16": gemm_bf16, "window_attn_relpos": window_attention,
                "layer_norm": layer_norm, "keys_stream": keys_stream, "t2i_attend": t2i_attend,
                "t2i_combine": t2i_combine, "window_crop": window_crop,
                "hull_support": support_points}
    # per batch: 12 layers x (qkv + proj + 2 MLP) GEMMs; 12 attentions;
    # LNs: neck 2 + decoder queries 7 (LN4 is inside keys_stream) + mask head 1;
    # keys stream: layer 0's per-image projection + one pass per decoder
    # layer, each joined by a combine (the t2i of layer 1 and the final one);
    # layer 0's t2i; one crop; one hull pass
    expected = {"gemm_bf16": 48, "window_attn_relpos": 12, "layer_norm": 10, "keys_stream": 3,
                "t2i_attend": 1, "t2i_combine": 2, "window_crop": 1, "hull_support": 1}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    timings: dict = {}
    out = pipe.process_batch_arrays(frames[:SLICE_BATCH], timings)
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    _say("slice", f"batch {SLICE_BATCH} first run {time.perf_counter() - t0:.2f} s; launches "
                  f"{launches} (expected {expected})")
    for name, n in launches.items():
        if n != expected[name]:
            raise AssertionError(f"{name}: {n} launches on the main path, expected {expected[name]}")

    b, k, cm = SLICE_BATCH, opts.max_det, opts.metric_crop
    shapes = {"boxes": (b, k, 4), "scores": (b, k), "valid": (b, k),
              "mask_crops": (b, k, cm, cm), "offsets": (b, k, 2)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {out[key].shape} != {shape}")
    finite = [np.isfinite(out["boxes"]).all(), np.isfinite(out["scores"]).all()]
    for key in METRIC_KEYS:
        if out["metrics"][key].shape != (b, k):
            raise AssertionError(f"metric {key}: shape {out['metrics'][key].shape}")
        finite.append(np.isfinite(out["metrics"][key]).all())
    if not all(finite):
        raise AssertionError("non-finite boxes, scores or metrics")
    if (out["metrics"]["area"][~out["valid"]] != 0).any():
        raise AssertionError("invalid detections carry a nonzero area")
    _say("slice", f"outputs: shapes ok, all finite; {int(out['valid'].sum())} valid cells in "
                  f"{b} frames; stage seconds {json.dumps({k: round(v, 4) for k, v in timings.items()})}")

    # bf16 embedding of one frame vs the fp32 plain path on the same card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = pipe._stages(FRAME, FRAME)
    scfg = st["scfg"]
    _, sam32 = from_jax_params(None, pipe._sam_params_for(scfg), "cuda", torch.float32,
                               sam_config=scfg)
    img = torch.from_numpy(frames[:1]).cuda()
    with torch.inference_mode():
        pix, _, _ = sam_preprocess_batch(img, scfg.image_size)
        emb16 = st["sam"].vision(pix.to(torch.bfloat16)).float()
        emb32 = sam32.vision(pix, plain=True)
    del sam32
    rel = ((emb16 - emb32).norm() / emb32.norm()).item()
    max_abs = (emb16 - emb32).abs().max().item()
    _say("slice", f"embedding bf16 kernels vs fp32 plain (1 frame, {tuple(emb32.shape)}): "
                  f"rel_rms={rel:.5f} (bound 0.05), max_abs={max_abs:.5f}, "
                  f"max|ref|={emb32.abs().max().item():.4f}")
    if not (rel <= 0.05 and torch.isfinite(emb16).all()):
        raise AssertionError("bf16 embedding disagrees with the fp32 plain path")

    # the bf16 decoder on the card (keys_stream, t2i_attend) vs the fp32 plain
    # decoder on the host, on that frame's embedding and 16 box prompts. Both
    # hold the same bf16-rounded weights: the pipeline casts every parameter,
    # the Fourier matrix too (its entries are O(400), so a bf16 rounding moves
    # the positional encodings by radians; the JAX engine does the same).
    _, sam_cpu = from_jax_params(None, pipe._sam_params_for(scfg), "cpu", torch.bfloat16,
                                 sam_config=scfg)
    sam_cpu = sam_cpu.float()
    boxes = torch.from_numpy(out["boxes"][:1])
    with torch.inference_mode():
        sparse = st["sam"].prompt.boxes(boxes.cuda()).to(torch.bfloat16)
        _, hyper16, grid16 = st["sam"].mask_decoder_tokens(emb32.to(torch.bfloat16), sparse)
        _, hyper32, grid32 = sam_cpu.mask_decoder_tokens(emb32.cpu(), sam_cpu.prompt.boxes(boxes))
    for name, got, want in (("keys grid", grid16, grid32), ("hypernetwork out", hyper16, hyper32)):
        got = got.float().cpu()
        rel = ((got - want).norm() / want.norm()).item()
        _say("slice", f"decoder {name} bf16 kernels vs fp32 plain (1 frame, 16 prompts, "
                      f"{tuple(want.shape)}): rel_rms={rel:.5f} (bound 0.05), "
                      f"max_abs={(got - want).abs().max().item():.5f}, "
                      f"max|ref|={want.abs().max().item():.4f}")
        if not (rel <= 0.05 and torch.isfinite(got).all()):
            raise AssertionError(f"bf16 decoder {name} disagrees with the fp32 plain decoder")
    del sam_cpu

    # timed pass at batch 32
    pipe.process_batch_arrays(frames)  # warm-up at this shape
    per_iter = []
    stage_tot: dict = {}
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_batch_arrays(frames, stage_tot)
        per_iter.append(time.perf_counter() - t0)
    ms = statistics.median(per_iter) * 1000
    _say("slice", f"config 1 timed: batch {TIMED_BATCH}, {TIMED_ITERS} iterations, median "
                  f"{ms:.2f} ms/batch = {TIMED_BATCH / ms * 1000:.2f} img/s "
                  f"(iterations ms {[round(t * 1000, 2) for t in per_iter]}) [{card}]")
    _say("slice", "stage ms/batch (mean): " + json.dumps(
        {key: round(v / TIMED_ITERS * 1000, 3) for key, v in stage_tot.items()}))
    return {"launches": launches, "ms_per_batch": ms}


def _sharing_params(pipe, options):
    """A second pipeline over ``pipe``'s host parameter trees (one init, one
    resolution adaptation) with other options: its stages are built anew."""
    import copy

    other = copy.copy(pipe)
    other.options = options
    other._stage_cache = {}
    return other


def _big_slice_phase(card: str, model: str, max_det: int, layers: int) -> dict:
    """One ViT-L/H path in bf16 and in int8, through process_batch_arrays."""
    import dataclasses

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops.decoder_fused import keys_stream, t2i_attend, t2i_combine
    from yolo_sam_inference_tpu_torch.ops.flash_attention import window_attention
    from yolo_sam_inference_tpu_torch.ops.hull_support import support_points
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
    from yolo_sam_inference_tpu_torch.ops.preprocess import sam_preprocess_batch
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    short = model.rsplit("-", 1)[-1]
    t0 = time.perf_counter()
    opts = tengine.PipelineOptions(max_det=max_det, metric_crop=128)
    pipe_b = tengine.CellSegmentationPipeline(sam_model_type=model, options=opts, device="cuda",
                                              seed=0)
    t_init = time.perf_counter() - t0
    pipes = {"bf16": pipe_b,
             "int8": _sharing_params(pipe_b, dataclasses.replace(opts, quant="int8"))}
    for mode, pipe in pipes.items():
        t0 = time.perf_counter()
        pipe._stages(FRAME, FRAME)
        _say("slice", f"{short} {mode}: stages built (adapt + cast"
                      f"{' + quantise' if mode == 'int8' else ''} + upload) "
                      f"{time.perf_counter() - t0:.2f} s")
    _say("slice", f"{short}: numpy init of the parameters {t_init:.2f} s (shared by both)")
    frames = cell_frames(np.random.default_rng(1), TIMED_BATCH, FRAME, cells=BIG_CELLS)

    wrappers = {"gemm_bf16": tln.gemm_bf16, "window_attn_relpos": window_attention,
                "fused_ln_matmul_int8": tln.fused_ln_matmul_int8,
                "fused_ln_mlp_int8": tln.fused_ln_mlp_int8,
                "fused_ln_mlp_tiled_int8": tln.fused_ln_mlp_tiled_int8,
                "layer_norm": tln.layer_norm, "keys_stream": keys_stream, "t2i_attend": t2i_attend,
                "t2i_combine": t2i_combine, "window_crop": window_crop,
                "hull_support": support_points}
    tiled = "huge" in model  # ViT-H's int8 tail is K11b, ViT-L's K11a
    common = {"window_attn_relpos": layers, "layer_norm": 10, "keys_stream": 3, "t2i_attend": 1,
              "t2i_combine": 2, "window_crop": 1, "hull_support": 1}
    # bf16: per layer K1 + projection + two K10 GEMMs; int8: the projection on
    # gemm_bf16, K11c, and the K11a or K11b tail
    expected = {
        "bf16": {**common, "gemm_bf16": 4 * layers, "fused_ln_matmul_int8": 0,
                 "fused_ln_mlp_int8": 0, "fused_ln_mlp_tiled_int8": 0},
        "int8": {**common, "gemm_bf16": layers, "fused_ln_matmul_int8": layers,
                 "fused_ln_mlp_int8": 0 if tiled else layers,
                 "fused_ln_mlp_tiled_int8": layers if tiled else 0},
    }
    result: dict = {"launches": {}, "ms_per_batch": {}, "rel_rms": {}}
    for mode, pipe in pipes.items():
        for w in wrappers.values():
            w.launches = 0
        timings: dict = {}
        out = pipe.process_batch_arrays(frames[:SLICE_BATCH], timings)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrappers.items()}
        _say("slice", f"{short} {mode}: batch {SLICE_BATCH} launches {launches} "
                      f"(expected {expected[mode]})")
        for name, n in launches.items():
            if n != expected[mode][name]:
                raise AssertionError(f"{short} {mode}: {name} launched {n} times on the path, "
                                     f"expected {expected[mode][name]}")
        result["launches"][mode] = launches
        b, k = SLICE_BATCH, max_det
        if out["mask_crops"].shape != (b, k, 128, 128) or out["boxes"].shape != (b, k, 4):
            raise AssertionError(f"{short} {mode}: output shapes {out['mask_crops'].shape}, "
                                 f"{out['boxes'].shape}")
        if not all(np.isfinite(out["metrics"][key]).all() for key in METRIC_KEYS):
            raise AssertionError(f"{short} {mode}: non-finite metrics")
        _say("slice", f"{short} {mode}: outputs ok, {int(out['valid'].sum())} valid cells in "
                      f"{b} frames")

    # the embedding of one frame against the fp32 plain encoder on the same
    # bf16-rounded float weights (the int8 path quantises those same weights)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = pipe_b._stages(FRAME, FRAME)
    scfg = st["scfg"]
    tree = tengine._round_floating(pipe_b._sam_params_for(scfg), torch.bfloat16)
    _, sam32 = from_jax_params(None, tree, "cuda", torch.float32, sam_config=scfg)
    img = torch.from_numpy(frames[:1]).cuda()
    with torch.inference_mode():
        pix, _, _ = sam_preprocess_batch(img, scfg.image_size)
        emb32 = sam32.vision(pix, plain=True)
        embs = {mode: pipe._stages(FRAME, FRAME)["sam"].vision(pix.to(torch.bfloat16)).float()
                for mode, pipe in pipes.items()}
    del sam32, tree
    for mode, bound in (("bf16", 0.05), ("int8", 0.10)):
        emb = embs[mode]
        rel = ((emb - emb32).norm() / emb32.norm()).item()
        result["rel_rms"][mode] = rel
        _say("slice", f"{short} {mode} embedding vs fp32 plain (1 frame, {tuple(emb32.shape)}): "
                      f"rel_rms={rel:.5f} (bound {bound}), max_abs="
                      f"{(emb - emb32).abs().max().item():.5f}, "
                      f"max|ref|={emb32.abs().max().item():.4f}")
        if not (rel <= bound and torch.isfinite(emb).all()):
            raise AssertionError(f"{short} {mode} embedding disagrees with the fp32 plain encoder")
    _say("slice", f"{short}: embedding rel_rms bf16 {result['rel_rms']['bf16']:.5f}, "
                  f"int8 {result['rel_rms']['int8']:.5f}")

    for mode, pipe in pipes.items():
        pipe.process_batch_arrays(frames)  # warm-up at this shape
        per_iter = []
        stage_tot: dict = {}
        for _ in range(TIMED_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.process_batch_arrays(frames, stage_tot)
            per_iter.append(time.perf_counter() - t0)
        ms = statistics.median(per_iter) * 1000
        result["ms_per_batch"][mode] = ms
        _say("slice", f"{short} {mode} timed: batch {TIMED_BATCH}, max_det {max_det}, "
                      f"{TIMED_ITERS} iterations, median {ms:.2f} ms/batch = "
                      f"{TIMED_BATCH / ms * 1000:.2f} img/s (iterations ms "
                      f"{[round(t * 1000, 2) for t in per_iter]}) [{card}]")
        _say("slice", f"{short} {mode} stage ms/batch (mean): " + json.dumps(
            {key: round(v / TIMED_ITERS * 1000, 3) for key, v in stage_tot.items()}))
    del pipes, pipe_b, embs
    torch.cuda.empty_cache()
    return result


def main() -> int:
    if not (ROOT / "yolo_sam_inference_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(yolo_sam_inference_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import card as bench_card

    _say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    card = bench_card()
    kind = torch.cuda.get_device_name(0)
    _say("env", f"device {kind}, count {torch.cuda.device_count()}, capability "
                f"{torch.cuda.get_device_capability(0)}")
    print(card, flush=True)  # name, power limit as nvidia-smi gives them

    from yolo_sam_inference_tpu_torch.ops import _build

    _, secs = _build.build()
    _build.kernels()
    _say("build", f"nvcc sm_90a build {secs:.2f} s (one nvcc per source, in parallel) -> "
                  f"{_build.library_path()}")
    for line in _ptxas_summary(_build.ptxas_report()):
        _say("build", line)

    kp = _kernel_phase(card)
    dp = _decoder_kernel_phase(card)
    sp = _slice_phase(card)
    bk = _big_kernel_phase(card)
    big = {model.rsplit("-", 1)[-1]: _big_slice_phase(card, model, max_det, layers)
           for model, max_det, layers, *_ in BIG_MODELS}

    t = kp["times"]
    table = [
        {"name": "gemm_bf16", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/gemm_bf16.cu",
         "replaces": "yolo_sam_inference_tpu/ops/fused_ln.py:645 fused_ln_matmul "
                     "(+ :202 fused_ln_mlp, projection of flash_attention.py:608)",
         "launches": sp["launches"]["gemm_bf16"], "max_abs_err": kp["errs"]["gemm_bf16"],
         "ms": t["gemm_bf16"][0], "plain_ms": t["gemm_bf16"][1]},
        {"name": "window_attn_relpos", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/window_attn_relpos.cu",
         "replaces": "yolo_sam_inference_tpu/ops/flash_attention.py:608 flash_attention_grid "
                     "(+ :1085 relpos_tables)",
         "launches": sp["launches"]["window_attn_relpos"],
         "max_abs_err": kp["errs"]["window_attn_relpos"],
         "ms": t["attn_w16"][0], "plain_ms": t["attn_w16"][1]},
        {"name": "layer_norm", "route": "triton",
         "source": "yolo_sam_inference_tpu_torch/ops/fused_ln.py",
         "replaces": "yolo_sam_inference_tpu/ops/fused_ln.py:761 fused_ln (+ :56 fused_add_ln)",
         "launches": sp["launches"]["layer_norm"], "max_abs_err": kp["errs"]["layer_norm"],
         "ms": t["layer_norm"][0], "plain_ms": t["layer_norm"][1]},
    ]
    dt = dp["times"]
    for name, replaces, timed in (
        ("keys_stream", "yolo_sam_inference_tpu/ops/decoder_fused.py:298 i2t_keys_update "
                        "(+ the k/v projections of :231 t2i_shared_attend)",
         "keys_stream layer 1 pass alone"),
        ("t2i_combine", "yolo_sam_inference_tpu/ops/decoder_fused.py:298 i2t_keys_update "
                        "(its next-stage t2i, joined over the tiles)", "t2i_combine"),
        ("t2i_attend", "yolo_sam_inference_tpu/ops/decoder_fused.py:231 t2i_shared_attend",
         "t2i_attend"),
        ("window_crop", "yolo_sam_inference_tpu/ops/window_crop.py:46 window_crop", "window_crop"),
        ("hull_support", "yolo_sam_inference_tpu/ops/hull_support.py:55 support_vertices_tpu",
         "hull_support"),
    ):
        src = "decoder_keys.cu" if name.startswith(("keys", "t2i")) else f"{name}.cu"
        table.append({"name": name, "route": "cuda",
                      "source": f"yolo_sam_inference_tpu_torch/csrc/{src}", "replaces": replaces,
                      "launches": sp["launches"][name], "max_abs_err": dp["errs"][name],
                      "ms": dt[timed][0], "plain_ms": dt[timed][1]})
    bt = bk["times"]
    lb, hb = big["large"]["launches"], big["huge"]["launches"]
    table += [
        {"name": "gemm_bf16 K10", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/gemm_bf16.cu",
         "replaces": "yolo_sam_inference_tpu/ops/fused_ln.py:302 fused_ln_mlp_tiled",
         "launches": lb["bf16"]["gemm_bf16"] + hb["bf16"]["gemm_bf16"],
         "max_abs_err": bk["errs"]["gemm_bf16"], "ms": bt["K10 ViT-H"][0],
         "plain_ms": bt["K10 ViT-H"][1]},
        {"name": "window_attn_relpos hd80", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/window_attn_relpos.cu",
         "replaces": "yolo_sam_inference_tpu/ops/flash_attention.py:608 flash_attention_grid "
                     "(+ :1085 relpos_tables)",
         "launches": hb["bf16"]["window_attn_relpos"] + hb["int8"]["window_attn_relpos"],
         "max_abs_err": bk["errs"]["window_attn_relpos"], "ms": bt["attn hd80 w16"][0],
         "plain_ms": bt["attn hd80 w16"][1]},
        {"name": "fused_ln_matmul_int8", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/gemm_int8.cu",
         "replaces": "yolo_sam_inference_tpu/ops/fused_ln.py:711 fused_ln_matmul_int8",
         "launches": lb["int8"]["fused_ln_matmul_int8"] + hb["int8"]["fused_ln_matmul_int8"],
         "max_abs_err": bk["errs"]["fused_ln_matmul_int8"], "ms": bt["K11c ViT-H"][0],
         "plain_ms": bt["K11c ViT-H"][1]},
        {"name": "fused_ln_mlp_int8", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/gemm_int8.cu",
         "replaces": "yolo_sam_inference_tpu/ops/fused_ln.py:438 fused_ln_mlp_int8",
         "launches": lb["int8"]["fused_ln_mlp_int8"],
         "max_abs_err": bk["errs"]["fused_ln_mlp_int8"], "ms": bt["K11a ViT-L"][0],
         "plain_ms": bt["K11a ViT-L"][1]},
        {"name": "fused_ln_mlp_tiled_int8", "route": "cuda",
         "source": "yolo_sam_inference_tpu_torch/csrc/gemm_int8.cu",
         "replaces": "yolo_sam_inference_tpu/ops/fused_ln.py:549 fused_ln_mlp_tiled_int8",
         "launches": hb["int8"]["fused_ln_mlp_tiled_int8"],
         "max_abs_err": bk["errs"]["fused_ln_mlp_tiled_int8"], "ms": bt["K11b ViT-H"][0],
         "plain_ms": bt["K11b ViT-H"][1]},
    ]
    for entry in table:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']}: no launch on its path")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase ends the run non-zero, no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke.py: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
