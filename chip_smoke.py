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
   plain version's (and beside bf16 torch, for context; the window attention
   beside ``scaled_dot_product_attention`` with the rel-pos bias as a bf16
   mask made beforehand, here and at every timed window); ``gemm_bf16``'s
   bare product (no LN) beside ``torch.addmm`` in turns at the qkv and mlp1
   shapes, and at a short M of 100 rows; the decoder's kernels also at
   T = 196 and 784 (the grids of the 224 and 448 canvases, whose last
   128-token tile is short), ``t2i_attend`` also at T = 4096 (config 4's
   grid), each T beside SDPA on the same inputs; the LayerNorm (K5) at the
   neck's, the mask head's and the decoder's rows (and its residual form),
   by events and on the device beside ``F.layer_norm`` with its weights cast
   to bf16 beforehand;
4. slice: the config-1 pipeline (YOLOv8n + SAM ViT-B, 512x512 uint8 frames,
   bf16, random weights from seed 0): one batch of 8 with every kernel's
   launch count checked, the bf16 image embedding of one frame against the
   fp32 plain path on the same card, the bf16 decoder on that frame's prompts
   against the fp32 plain decoder, and a timed pass at batch 32;
4b. K17: ``conv2d_act`` at its seven batch-32 shapes of the paths (the YOLO
   stem, a C2f bottleneck on a channel slice, a detect tower, down5, the SAM
   neck without bias, TinyViT's stem1 with GELU, the s2d k = 2 exit) against
   its fp32 plain version, timed beside it (and its device time from
   ``torch.profiler``), the bound and ``F.conv2d`` on channels-last bf16;
   then config 1 with ``PipelineOptions(conv2d_fused=
   True)`` on the same parameters and frames: launch counts at batch 8 (39
   YOLO convs + the neck), the raw YOLO maps of one frame and the embedding
   against fp32 plain versions (the default route's YOLO maps too), a timed
   pass at batch 32 beside the default route's;
4c. directory: the disk-to-CSV path at config 1 on the slice's
   stages, batch 32: 256 mode-L PNG frames through ``process_directory``
   with PIL hidden from the decoder (launch counts over its 8 batches and
   the timing sample), each image's rows against ``process_batch_arrays`` on
   the same batch (rtol = atol = 1e-5), the CSVs read back, the
   visualisations of 4 files, the bitpack round trip against the bool crops
   and the fetch timed both ways, ``fused_call_chunked`` on 2 x 32 frames
   against two ``fused_call`` (exact), ``fused_call`` img/s; then
   ``bench/e2e.py`` at batch 32, 3 iterations, its directory leg on;
5. big kernels: the kernels of the ViT-L/H paths at their batch-32 shapes:
   ``gemm_bf16`` at the ViT-L/H qkv and MLP (K10) widths and the attention at
   hd 80 against fp32 plain versions, and the w8a8 kernels (K11c, K11a,
   K11b) against their plain int8 versions on the same bf16 inputs, beside
   ``torch._int_mm`` of their bare int8 products (no one call computes their
   functions);
6. big slices: ``facebook/sam-vit-large`` (max_det 50, frames with 40 cells:
   config 3's multi-box traffic) and ``facebook/sam-vit-huge`` (max_det 16),
   each in bf16 and with ``quant="int8"`` from one parameter tree: a batch of
   8 with every launch count checked, the image embedding of one frame
   against the fp32 plain encoder on the same bf16-rounded float weights,
   and a timed pass at batch 32;
7. large-frame kernels: the attention at windows 48 and 64 (the global
   layers of the 768 and 1024 canvases), hd 64 and 80, at batch-32 shapes;
8. large frames: ``facebook/sam-vit-huge`` in bf16 on 2048x2048 frames
   (config 4: the 1024 canvas, windows 16 and 64; ViT-H's parameter tree of
   phase 6, its rel-pos tables, positional embedding, biases and LN affines
   drawn at random first) and ViT-B on 768x768 frames (windows 16 and 48): launch counts
   by window at batch 8, outputs, the embedding against the fp32 plain
   encoder, a timed batch;
9. MobileSAM kernels: K13-K16 (``tinyvit_window_block``, one launch at
   stages 1 and 2, at stage 3 ``gemm_bf16`` + ``tinyvit_attention`` (also
   alone, beside SDPA) + ``gemm_bf16``, against the official pad-then-LN
   block in fp32; ``mbconv_block``,
   ``patch_merge_block`` (K14 and K15 on one kernel), ``dw_conv3x3`` and its
   tail) at TinyViT-5M's batch-32 shapes against fp32
   plain versions (the depthwise as one pass writing y and LN(y): y within
   2% of range, LN(y) within 1% of the plain LayerNorm of its own y; then y
   alone beside ``F.conv2d(groups=C)``); K14 and K15 with ``compute="bf16"``
   at stage 0, merge0 and merge1
   against their bf16-compute plain versions and, within the JAX package's
   bound for the mode, fp32 plain, timed in turns with the fp32
   instantiation;
10. MobileSAM slice (``"mobile-sam"``, config 2: TinyViT-5M + SAM ViT-B's
   decoder, 512x512 frames, bf16): launch counts at batch 8, the embedding
   against the fp32 plain TinyViT, a timed pass at batch 32; then with
   ``conv2d_fused=True`` (42 ``conv2d_act`` launches: YOLO's 39, the two
   stems, the neck), the embedding against fp32 plain and a timed pass;
   then with ``tinyvit_mbconv_compute="bf16"`` (the bf16 instantiations
   counted apart), the embedding, and passes in turns with the default;
11. K12 kernels: ``flash_attention_relpos`` at its three shapes of batch 32
   (a sequence-parallel rank's 2048 queries of ViT-H's 64 x 64 grid, q a
   view of its qkv and k, v views of the gathered k | v half; the flat
   route's ViT-B global layer on the 40 x 40 grid of the 640 canvas and its
   14 x 14 windows, q, k, v views of the fused qkv; the raw rel-pos tables),
   plain and at sampled |q.k / sqrt(hd)| of 30-60, against the fp32 plain
   version, timed by events and on the device (``torch.profiler``) beside
   it, the bound and ``scaled_dot_product_attention`` with the bias as a
   bf16 mask; at the flat shapes also the whole ``relpos_grid_attention``
   route; the residual LayerNorm (K11d) at the flat tails' rows, on the
   device too; and ``int8_linear`` (the int8 flat route's qkv, mlp1 and
   mlp2) beside ``torch._int_mm``;
12. off-grid slice: ViT-B bf16 at ``sam_encoder_size=640`` (grid 40,
   windows of 14 padded to 42: the flat route; rel-pos tables, positional
   embedding, biases and LN affines at random) on 640x640 frames, launch
   counts at batch 8 (K12 and K11d, no window attention), the embedding and
   decoder against fp32 plain versions; the same with ``quant="int8"``
   (launch counts at batch 8, the embedding within 10% of fp32 plain), both
   timed at batch 32 in turns; then the 896 canvas (grid 56, window 14: the
   flat route without padding) and the 448 and 224 canvases (grids 28 and
   14: the decoder over 784 and 196 tokens) at batch 2;
13. sequence-parallel slice: config 4's encoder (ViT-H bf16, 2048x2048
   frames, 1024 canvas, phase 8's random tables) with
   ``encoder_parallel="sp"`` on 2 ranks
   (``parallel/launch.py``; gloo with both ranks on the one card): launch
   counts per rank, the embedding equal across ranks bit for bit and against
   phase 8's single-card bf16 and fp32 plain embeddings of the same frames,
   a timed batch (two ranks sharing one card: no speed-up is measured);
   then ViT-B at the 896 canvas the same way (each rank's 14 x 14 windows
   on K12), against phase 12's single-card 896 and fp32 plain embeddings;
14. result: the kernel table as one JSON line (each kernel's launches on its
   path, the window attention's counted by window: windows of 16 run on
   ``window_attn_relpos.cu``, the others on ``flash_attention_relpos.cu``;
   error, ms, plain ms, the bound for the same work on an H100 and
   what sets it, and the time of one PyTorch call that computes the same
   function where there is one, all by CUDA events; beside them
   "device_ms" and "library_device_ms", the same calls' device times from
   ``torch.profiler``, null where not measured), then the last line
   ``{"ok": true, "device": {...}}``.

Bounds use the published H100 SXM peaks: 3.35 TB/s of device memory, 989
TFLOP/s dense bf16, 1979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor
cores; each input counted read once and each output written once.
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
LARGE_FRAME = 2048  # config 4's TIFF frames (the 1024 canvas)
MID_FRAME = 768  # the 768 canvas (global window 48)
OFF_GRID = 640  # the off-grid canvas and frames (grid 40, window 14)
SP_RANKS = 2  # sequence-parallel ranks (one card: they share it)
SP_BATCH = 2  # frames per sequence-parallel batch
DIR_FILES = 256  # PNG files through process_directory (8 batches of TIMED_BATCH)
# published H100 SXM peaks (NVIDIA data sheet): bytes/s and operations/s
PEAK = {"hbm": 3.35e12, "bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# the decoder, crop and hull kernels of one batch (max_det prompts an image)
DECODER_COUNTS = {"layer_norm": 10, "keys_stream": 3, "t2i_attend": 1, "t2i_combine": 2,
                  "window_crop": 1, "hull_support": 1}


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


def _bound(flops: float, nbytes: float, rate: str = "bf16") -> tuple:
    """(least ms on an H100, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the peak rate of their type."""
    t_ops = flops / PEAK[rate] * 1e3
    t_mem = nbytes / PEAK["hbm"] * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)



def _int_mm_ms(a, w) -> float:
    """Median ms of ``torch._int_mm(a, w)``, the bare int8 product: a
    library yardstick beside the w8a8 kernels, which the port never calls.
    Some builds take the weight only column-major: then its column-major
    copy, made before timing."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms

    try:
        torch._int_mm(a, w)
    except RuntimeError:
        w = w.t().contiguous().t()
    return median_ms(lambda: torch._int_mm(a, w))

def _attn_flops(windows: int, heads: int, t: int, hd: int, rel_rows: int = 0) -> float:
    """Window attention: q.k and p.v over t keys (4 t^2 hd a window and head),
    plus each query's dot products with the rel_rows rows of each rel-pos
    table that its bias needs (the window's side: one row for each key row,
    one for each key column)."""
    return windows * heads * (4.0 * t * t * hd + 4.0 * t * rel_rows * hd)


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


def _relpos_sdpa_ms(label: str, qkv, rel_h, rel_w, heads: int, window: int, got, card: str,
                    cap: int = 8 << 30) -> float:
    """K3's library yardstick: ``scaled_dot_product_attention`` over the
    windows of ``qkv`` with the decomposed rel-pos bias (from the unscaled q)
    built beforehand, not timed, as a bf16 (windows, heads, T, T) mask, as
    for K12. Where the mask of the whole batch passes ``cap`` bytes, it is
    timed on the first images and scaled to the batch. Its output on those
    images is held against ``got``, the kernel's, within 5% of range: a
    sanity check that it computes the same function (both sides bf16), not
    a gate of the port. Returns the ms for the whole batch."""
    import torch
    import torch.nn.functional as F

    from yolo_sam_inference_tpu_torch.bench.common import median_ms

    b, s, _, c3 = qkv.shape
    c, w = c3 // 3, window
    hd, nw, t = c // heads, s // window, window * window
    n = max(1, min(b, cap // (nw * nw * heads * t * t * 2)))

    def windows(part):  # (n nw nw, heads, T, hd)
        x = qkv[:n, ..., part * c:(part + 1) * c].reshape(n, nw, w, nw, w, heads, hd)
        return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, heads, t, hd).contiguous()

    q, k, v = windows(0), windows(1), windows(2)
    idx = (torch.arange(w)[:, None] - torch.arange(w)[None, :] + w - 1).to(qkv.device)
    rh_tab, rw_tab = rel_h.float()[idx], rel_w.float()[idx]
    mask = torch.empty((q.shape[0], heads, t, t), dtype=torch.bfloat16, device=qkv.device)
    for j in range(q.shape[0]):  # a window at a time, in fp32
        qf = q[j].float().reshape(heads, w, w, hd)
        rh = torch.einsum("hyxd,ykd->hyxk", qf, rh_tab)
        rw = torch.einsum("hyxd,xkd->hyxk", qf, rw_tab)
        mask[j] = (rh[..., :, None] + rw[..., None, :]).reshape(heads, t, t)
    fn = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    o = fn().reshape(n, nw, nw, heads, w, w, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(n, s, s, c)
    _check(f"sdpa yardstick of window_attn_relpos {label} (vs the kernel)", o, got[:n], 5e-2, {})
    ms = median_ms(fn) * b / n
    _say("kernels", f"window_attn_relpos {label}: SDPA with a bf16 mask of "
                    f"{_nbytes(mask) / 2 ** 30:.2f} GiB, timed on {n} of {b} images"
                    f"{'' if n == b else ', scaled to the batch'}: {ms:.4f} ms [{card}]")
    del q, k, v, mask, o
    torch.cuda.empty_cache()
    return ms


def _kernel_phase(card: str) -> dict:
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import device_ms, median_ms
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
    bounds: dict = {}  # timed case -> (bound ms, "bytes" or "operations")
    device: dict = {}  # timed case -> (kernel, library call) device ms from torch.profiler

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
    bounds["gemm_bf16"] = _bound(2.0 * m * c * 3 * c,
                                 _nbytes(x, ln_s, ln_b, w_qkv, b_qkv) + m * 3 * c * 2)
    bf16_k4 = lambda: torch.addmm(b2.to(bf), torch.addmm(b1.to(bf), x, w1), w2)
    t_k4 = (median_ms(k4), median_ms(k4p), median_ms(bf16_k4))
    bounds["K4"] = _bound(4.0 * m * c * hidden, _nbytes(x, h, ln_s, ln_b, w1, b1, w2, b2) + m * c * 2)
    _say("kernels", f"gemm_bf16 K4 (2 launches): kernel {t_k4[0]:.4f} ms, plain "
                    f"{t_k4[1]:.4f} ms, torch bf16 addmm x2 (no LN, GELU, residual) "
                    f"{t_k4[2]:.4f} ms [{card}]")
    for key in ("gemm_bf16", "K4"):
        _say("kernels", f"{key} bound {bounds[key][0]:.4f} ms ({bounds[key][1]})")
    # the bare product (bias only, no LN pass) beside addmm at the qkv and
    # mlp1 shapes, in turns: what is left of the LN's cost is K1's time less
    # this one
    for label, wb, bb in (("qkv", w_qkv, b_qkv), ("mlp1", w1, b1)):
        fn = lambda: gemm_bf16(x, wb, bb)
        lib = lambda: torch.addmm(bb.to(bf), x, wb)
        _check(f"gemm_bf16 bare {label} (32768x768 @ 768x{wb.shape[1]})", fn(),
               gemm_plain(xf, wb, bb), 2e-2, errs)
        t_bare = (median_ms(fn), median_ms(lib), median_ms(lib), median_ms(fn))
        times[f"gemm_bf16 bare {label}"] = t_bare
        _say("kernels", f"gemm_bf16 bare {label}: kernel {t_bare[0]:.4f}, {t_bare[3]:.4f} ms, "
                        f"torch bf16 addmm {t_bare[1]:.4f}, {t_bare[2]:.4f} ms (in turns), "
                        f"{2.0 * m * c * wb.shape[1] / min(t_bare[0], t_bare[3]) / 1e9:.0f} "
                        f"TFLOP/s [{card}]")
    xs = randn(100, c).to(bf)  # a short M: one partial row tile
    _check("gemm_bf16 short M (100x768 @ 768x2304, ln)",
           fused_ln_matmul(xs, ln_s, ln_b, w_qkv, b_qkv),
           fused_ln_matmul(xs.float(), ln_s, ln_b, w_qkv, b_qkv, gemm=gemm_plain), 2e-2, errs)

    # window_attn_relpos: K2 + K3 at window 16 (8 layers) and 32 (4 global layers)
    b_att = TIMED_BATCH
    k3_library: dict = {}
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
        got = fn()
        _check(f"window_attn_relpos {label} ({b_att}x32x32x2304)", got,
               window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2, errs)
        if std_qk == 1.0:
            times[f"attn_{label}"] = (median_ms(fn), median_ms(fnp, reps=5))
            k3_library[f"attn_{label}"] = _relpos_sdpa_ms(label, qkv, rel_h, rel_w, heads,
                                                          window, got, card)
            bounds[f"attn_{label}"] = _bound(
                _attn_flops(b_att * (32 // window) ** 2, heads, window * window, 64, window),
                _nbytes(qkv, rel_h, rel_w) + qkv.numel() // 3 * 2)
            _say("kernels", f"window_attn_relpos {label}: kernel {times[f'attn_{label}'][0]:.4f} "
                            f"ms, plain {times[f'attn_{label}'][1]:.4f} ms, bound "
                            f"{bounds[f'attn_{label}'][0]:.4f} ms ({bounds[f'attn_{label}'][1]}) "
                            f"[{card}]")

    # layer_norm (K5): the neck's rows at C 256, the mask head's up_ln at C 64,
    # the decoder's at C 256 (and the residual form there); each timed by
    # events and on the device beside F.layer_norm, its weights cast to bf16
    # before the timed calls
    ln_library: dict = {}
    for rows, cc, res, label in ((KERNEL_ROWS, 256, False, "neck 32768x256"),
                                 (32 * 16 * 44 * 44, 64, False, "up_ln 991232x64"),
                                 (32 * 16 * 7, 256, False, "decoder 3584x256"),
                                 (32 * 16 * 7, 256, True, "add+ln 3584x256")):
        xl = randn(rows, cc).to(bf)
        rl = randn(rows, cc).to(bf) if res else None
        sl, bl = 1.0 + randn(cc, std=0.1), randn(cc, std=0.1)
        got = layer_norm(xl, sl, bl, 1e-6, residual=rl)
        ref = layer_norm_plain(xl.float(), sl, bl, 1e-6,
                               residual=None if rl is None else rl.float())
        if res:
            _check(f"layer_norm {label} (sum)", got[0], ref[0], 1e-2, errs)
            _check(f"layer_norm {label}", got[1], ref[1], 1e-2, errs)
            continue
        _check(f"layer_norm {label}", got, ref, 1e-2, errs)
        key = f"layer_norm {label.split()[0]}"
        sl16, bl16 = sl.to(bf), bl.to(bf)
        fn = lambda: layer_norm(xl, sl, bl, 1e-6)
        lib = lambda: torch.nn.functional.layer_norm(xl, (cc,), sl16, bl16, 1e-6)
        times[key] = (median_ms(fn), median_ms(lambda: layer_norm_plain(xl, sl, bl, 1e-6)),
                      median_ms(lib))
        dev_k, dev_l = device_ms(fn, "layer_norm"), device_ms(lib, "layer_norm")
        device[key] = (dev_k, dev_l)
        ln_library[key] = times[key][2]
        bounds[key] = _bound(8.0 * xl.numel(), 2 * _nbytes(xl) + _nbytes(sl, bl), "fp32")
        _say("kernels", f"layer_norm {label}: kernel {times[key][0]:.4f} ms by events, "
                        f"{_fmt(dev_k)} on the device; plain {times[key][1]:.4f} ms; "
                        f"F.layer_norm (bf16 weights cast beforehand) {times[key][2]:.4f} ms by "
                        f"events, {_fmt(dev_l)} on the device; bound {bounds[key][0]:.4f} ms "
                        f"({bounds[key][1]}) [{card}]")
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "t_k4": t_k4, "bounds": bounds, "device": device,
            "library": {**ln_library, **k3_library}}


def _fmt(ms) -> str:
    """A device time, or "not measured" where the profiler recorded none."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


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
    bounds: dict = {}
    library: dict = {}

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
    # K6's projection pass: k and v (2 C dh each a token)
    bounds["keys_stream k/v projection (32 images)"] = _bound(
        4.0 * b * t * c * dh, _nbytes(img, pe, w["wk"], w["wv"], bk, bv) + 2 * b * t * dh * 2)
    keys1, part = pass1()  # layer 1's new keys and partials
    # per token: q, out, k and v projections (8 C dh), i2t over tq and the
    # next attention's partials over tq (4 dh each a query)
    bounds["keys_stream layer 1 pass alone"] = _bound(
        n * t * (8.0 * c * dh + 4.0 * 2 * tq * dh),
        _nbytes(keys, pe, kq, vq, qn, bq, bk, bv, bo, ln_s, ln_b, *w.values(), keys1, part))
    fn, ref = lambda: dec.t2i_combine(part, tq), lambda: dec.t2i_combine_plain(part, tq)
    _check(f"t2i_combine (512 streams x {part.shape[1]} tiles)", fn(), ref(), 2e-2, errs)
    times["t2i_combine"] = (median_ms(fn), median_ms(ref))
    bounds["t2i_combine"] = _bound(0.0, _nbytes(part) + n * tq * dh * 2)
    # t2i_attend: layer 0's per-image k/v shared by 16 prompts (K6)
    qp = randn(n, tq, dh, std=0.25)
    kp_, vp_ = randn(b, t, dh), randn(b, t, dh)
    fn = lambda: dec.t2i_attend(qp, kp_, vp_, 8, k)
    ref = lambda: dec.t2i_attend_plain(qp.float(), kp_.float(), vp_.float(), 8, k)
    _check("t2i_attend shared (k_share 16)", fn(), ref(), 2e-2, errs)
    times["t2i_attend"] = (median_ms(fn), median_ms(ref, reps=5))
    bounds["t2i_attend"] = _bound(4.0 * n * tq * t * dh, _nbytes(qp, kp_, vp_) + _nbytes(qp))
    # one library call on the same inputs: an image's 16 prompts share its
    # keys, so their 16 x 7 (pre-scaled) queries attend as one sequence
    def sdpa_of(kv_k, kv_v):
        tt = kv_k.shape[1]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qp.reshape(b, k * tq, 8, 16).transpose(1, 2),
            kv_k.reshape(b, tt, 8, 16).transpose(1, 2), kv_v.reshape(b, tt, 8, 16).transpose(1, 2),
            scale=1.0)

    library["t2i_attend"] = median_ms(sdpa_of(kp_, vp_))
    # window_crop: a copy, exact
    grid = randn(n, 32, 32, c)
    r0, c0 = (torch.randint(0, 32 - 11 + 1, (n,), generator=g).to(dev) for _ in range(2))
    fn, ref = lambda: window_crop(grid, r0, c0, 11), lambda: window_crop_plain(grid, r0, c0, 11)
    _check("window_crop (512x32x32x256 -> 11x11)", fn(), ref(), 0.0, errs)
    times["window_crop"] = (median_ms(fn), median_ms(ref))
    bounds["window_crop"] = _bound(0.0, 2 * n * 11 * 11 * c * 2 + _nbytes(r0, c0))  # the crops only
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
    # a dot product (2 mul, 1 add) and a compare per candidate and direction
    bounds["hull_support"] = _bound(4.0 * n * pts.shape[1] * 256, _nbytes(pts, dirs, fn()), "fp32")
    del keys, keys1, part, grid
    torch.cuda.empty_cache()

    # the grids of the 224 and 448 canvases: T = 196 and 784 tokens, whose
    # last 128-token tile is short; each kernel against its fp32 plain version
    for gs in (14, 28):
        tt, tag = gs * gs, f"T{gs * gs}"
        pe_t, img_t, keys_t = randn(tt, c), randn(b, tt, c), randn(n, tt, c)
        fn = lambda: dec.i2t_keys_update(keys_t, pe_t, kq, vq, *w_i2t, heads=8,
                                         t2i={"qp": qn, **nxt})
        ref = lambda: dec.i2t_keys_update_plain(
            keys_t.float(), pe_t.float(), kq.float(), vq.float(), *w_i2t, heads=8,
            t2i={"qp": qn.float(), **nxt})
        for got, want, part_name in zip(fn(), ref(), ("keys", "attn")):
            _check(f"keys_stream i2t layer 1 {tag} (512 streams): {part_name}", got, want, 2e-2,
                   errs)
        for got, want, part_name in zip(dec.kv_project(img_t, pe_t, *kv, 8),
                                        dec.kv_project_plain(img_t.float(), pe_t.float(), *kv),
                                        ("kp", "vp")):
            _check(f"keys_stream k/v projection {tag} (32 images): {part_name}", got, want, 2e-2,
                   errs)
        pass_t = lambda: dec.keys_stream(keys_t, pe_t, *kv, qn=qn, i2t=(kq, vq, *w_i2t))
        keys1, part = pass_t()
        times[f"keys_stream {tag}"] = (median_ms(pass_t), median_ms(ref, reps=3, warmup=1))
        bounds[f"keys_stream {tag}"] = _bound(
            n * tt * (8.0 * c * dh + 4.0 * 2 * tq * dh),
            _nbytes(keys_t, pe_t, kq, vq, qn, bq, bk, bv, bo, ln_s, ln_b, *w.values(), keys1,
                    part))
        fn, ref = lambda: dec.t2i_combine(part, tq), lambda: dec.t2i_combine_plain(part, tq)
        _check(f"t2i_combine {tag} (512 streams x {part.shape[1]} tiles)", fn(), ref(), 2e-2, errs)
        times[f"t2i_combine {tag}"] = (median_ms(fn), median_ms(ref))
        bounds[f"t2i_combine {tag}"] = _bound(0.0, _nbytes(part) + n * tq * dh * 2)
        kp_t, vp_t = randn(b, tt, dh), randn(b, tt, dh)
        fn = lambda: dec.t2i_attend(qp, kp_t, vp_t, 8, k)
        ref = lambda: dec.t2i_attend_plain(qp.float(), kp_t.float(), vp_t.float(), 8, k)
        _check(f"t2i_attend {tag} shared (k_share 16)", fn(), ref(), 2e-2, errs)
        times[f"t2i_attend {tag}"] = (median_ms(fn), median_ms(ref, reps=5))
        bounds[f"t2i_attend {tag}"] = _bound(4.0 * n * tq * tt * dh, _nbytes(qp, kp_t, vp_t, qp))
        library[f"t2i_attend {tag}"] = median_ms(sdpa_of(kp_t, vp_t))
        del pe_t, img_t, keys_t, keys1, part, kp_t, vp_t
        torch.cuda.empty_cache()
    # T 4096: the 64 x 64 grid of config 4's 1024 canvas
    kp_t, vp_t = randn(b, 4096, dh), randn(b, 4096, dh)
    fn = lambda: dec.t2i_attend(qp, kp_t, vp_t, 8, k)
    ref = lambda: dec.t2i_attend_plain(qp.float(), kp_t.float(), vp_t.float(), 8, k)
    _check("t2i_attend T4096 shared (k_share 16)", fn(), ref(), 2e-2, errs)
    times["t2i_attend T4096"] = (median_ms(fn), median_ms(ref, reps=5))
    bounds["t2i_attend T4096"] = _bound(4.0 * n * tq * 4096 * dh, _nbytes(qp, kp_t, vp_t, qp))
    library["t2i_attend T4096"] = median_ms(sdpa_of(kp_t, vp_t))
    del kp_t, vp_t
    for name, (ms, plain) in times.items():
        extra = f", bound {bounds[name][0]:.4f} ms ({bounds[name][1]})" if name in bounds else ""
        if name in library:
            extra += f", library {library[name]:.4f} ms"
        _say("kernels", f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms{extra} [{card}]")
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library}


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
    bounds: dict = {}
    int_mm: dict = {}
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
        qkv_io = _nbytes(x, ln_s, ln_b, w_qkv, b_qkv) + m * 3 * c * 2
        tail_io = _nbytes(x, h, ln_s, ln_b, w1, b1, w2, b2) + m * c * 2
        bounds[f"K1 {tag}"] = _bound(2.0 * m * c * 3 * c, qkv_io)
        bounds[f"K10 {tag}"] = _bound(4.0 * m * c * hidden, tail_io)
        # the bare products (no LN, GELU or residual) on the library's GEMM
        addmm = (median_ms(lambda: torch.addmm(b_qkv, x, w_qkv)),
                 median_ms(lambda: torch.addmm(b2, torch.addmm(b1, x, w1), w2)))
        _say("kernels", f"torch bf16 addmm {tag}: qkv {addmm[0]:.4f} ms, mlp1 + mlp2 "
                        f"{addmm[1]:.4f} ms [{card}]")

        # w8a8 against the plain int8 versions on the same bf16 inputs
        bounds[f"K11c {tag}"] = _bound(2.0 * m * c * 3 * c,
                                       qkv_io - _nbytes(w_qkv) + _nbytes(q_qkv, s_qkv), "int8")
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
        bounds[name.split()[1] + f" {tag}"] = _bound(
            4.0 * m * c * hidden, tail_io - _nbytes(w1, w2) + _nbytes(q1, s1, q2, s2), "int8")
        # the bare int8 products on torch._int_mm: qkv; mlp1 + mlp2
        xq = torch.randint(-127, 128, (m, c), generator=g, dtype=torch.int8).to(dev)
        hq = torch.randint(-127, 128, (m, hidden), generator=g, dtype=torch.int8).to(dev)
        int_mm[f"K11c {tag}"] = _int_mm_ms(xq, q_qkv)
        int_mm[f"{name.split()[1]} {tag}"] = _int_mm_ms(xq, q1) + _int_mm_ms(hq, q2)
        del xq, hq
        for key in (f"K1 {tag}", f"K11c {tag}", f"K10 {tag}", f"{name.split()[1]} {tag}"):
            lib = f", torch._int_mm of the bare products {int_mm[key]:.4f} ms" if key in int_mm \
                else ""
            _say("kernels", f"{key}: kernel {times[key][0]:.4f} ms, plain {times[key][1]:.4f} ms, "
                            f"bound {bounds[key][0]:.4f} ms ({bounds[key][1]}){lib} [{card}]")
        del x, h, w_qkv, w1, w2, q_qkv, q1, q2, xf, hf
        torch.cuda.empty_cache()

    # window_attn_relpos at hd 80 (ViT-H: 16 heads of 80): windows 16 and 32,
    # and with |q.k / sqrt(80)| ~ 30
    c, heads, hd = 1280, 16, 80
    library: dict = {}
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
        got = fn()
        _check(f"window_attn_relpos {label} ({TIMED_BATCH}x32x32x{3 * c})", got,
               window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2, errs)
        if std_qk == 1.0:
            times[f"attn {label}"] = (median_ms(fn), median_ms(fnp, reps=5))
            library[f"attn {label}"] = _relpos_sdpa_ms(label, qkv, rel_h, rel_w, heads, window,
                                                       got, card)
            bounds[f"attn {label}"] = _bound(
                _attn_flops(TIMED_BATCH * (32 // window) ** 2, heads, window * window, hd,
                            window),
                _nbytes(qkv, rel_h, rel_w) + qkv.numel() // 3 * 2)
            _say("kernels", f"window_attn_relpos {label}: kernel {times[f'attn {label}'][0]:.4f} "
                            f"ms, plain {times[f'attn {label}'][1]:.4f} ms, bound "
                            f"{bounds[f'attn {label}'][0]:.4f} ms ({bounds[f'attn {label}'][1]}) "
                            f"[{card}]")
        del qkv, got
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library,
            "int_mm": int_mm}


def _large_kernel_phase(card: str) -> dict:
    """The attention at windows 48 and 64 (the global layers of the 768 and
    1024 canvases; ViT-B/L hd 64 with 12 heads, ViT-H hd 80 with 16) at
    batch-32 shapes, against the fp32 plain version, plain and with sampled
    logits of |q.k / sqrt(hd)| ~ 30."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.ops.flash_attention import (
        window_attention,
        window_attention_plain,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(3)
    errs: dict = {}
    times: dict = {}
    bounds: dict = {}
    library: dict = {}
    for window, hd in ((48, 64), (48, 80), (64, 64), (64, 80)):
        heads = 12 if hd == 64 else 16
        c = heads * hd
        qkv = (torch.randn(TIMED_BATCH, window, window, 3 * c, generator=g)).to(dev, bf)
        rel_h, rel_w = ((torch.randn(2 * window - 1, hd, generator=g) * 0.3).to(dev, bf)
                        for _ in range(2))
        label = f"w{window} hd{hd}"
        fn = lambda: window_attention(qkv, rel_h, rel_w, heads, window)
        fnp = lambda: window_attention_plain(qkv, rel_h, rel_w, heads, window)
        got = fn()
        _check(f"window_attn_relpos {label} ({TIMED_BATCH}x{window}x{window}x{3 * c})", got,
               window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2, errs)
        times[label] = (median_ms(fn), median_ms(fnp, reps=3, warmup=1))
        library[label] = _relpos_sdpa_ms(label, qkv, rel_h, rel_w, heads, window, got, card)
        del got
        bounds[label] = _bound(_attn_flops(TIMED_BATCH, heads, window * window, hd, window),
                               _nbytes(qkv, rel_h, rel_w) + qkv.numel() // 3 * 2)
        _say("kernels", f"window_attn_relpos {label}: kernel {times[label][0]:.4f} ms, plain "
                        f"{times[label][1]:.4f} ms, bound {bounds[label][0]:.4f} ms "
                        f"({bounds[label][1]}) [{card}]")
        qkv[..., :2 * c] *= 2.8 if hd == 80 else 3.2  # logits of |s| ~ 30
        q = qkv[..., :c].float().reshape(TIMED_BATCH, window, window, heads, hd)
        kk = qkv[..., c:2 * c].float().reshape(TIMED_BATCH, window, window, heads, hd)
        s_max = (q[:4] * hd ** -0.5 * kk[:4, :1, :1]).sum(-1).abs().max().item()
        _say("kernels", f"attention {label} |s|~30: sampled max |q.k/sqrt({hd})| = {s_max:.1f}")
        _check(f"window_attn_relpos {label} |s|~30", fn(),
               window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2, errs)
        del qkv, q, kk
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library}


def _relpos_kernel_phase(card: str) -> dict:
    """K12 (``flash_attention_relpos``) at the shapes of its two paths, batch
    32, against its fp32 plain version (TF32 off): a sequence-parallel rank's
    share of ViT-H's global layer (rank 1 of 2: rows 32-63 of the 64 x 64
    grid, 2048 queries over 4096 keys, hd 80; q a view of the rank's qkv, k
    and v views of the gathered k | v half), the flat route's ViT-B global
    layer at the 640 canvas (40 x 40 grid, hd 64) and its 14 x 14 windows
    (nine windows an image, 196 keys), q, k and v views of the fused qkv.
    The kernel takes the raw rel-pos tables and builds the bias inside. Each
    plain and with q and k scaled to sampled |q.k / sqrt(hd)| of 30-50;
    times by events and on the device (``torch.profiler``) beside the plain
    version's, the bound and ``scaled_dot_product_attention`` with the bias
    materialised as a bf16 additive mask beforehand (which the port never
    calls); at the two flat shapes also the whole ``relpos_grid_attention``
    route (qkv in, output out). Then the residual LayerNorm (K11d) at the
    flat tails' rows (32 x 1600 tokens x 768), beside ``F.layer_norm`` of
    the same rows, and the int8 flat route's ``int8_linear`` (row
    quantisation + gemm_int8) at its qkv, mlp1 and mlp2 on the global
    layer's rows, against its plain int8 version, beside ``torch._int_mm``
    for the bare int8 product."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import device_ms, median_ms
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops.flash_attention import (
        flash_attention_relpos,
        relpos_attention_plain,
        relpos_grid_attention,
        relpos_score_tables,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(6)

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    errs: dict = {}
    times: dict = {}
    bounds: dict = {}
    library: dict = {}
    device: dict = {}  # case -> (kernel, library call) device ms
    routes: dict = {}  # flat case -> (route ms by events, on the device)
    # (label, images, heads, hd, grid side, query rows, first row, scale to |s| ~ 30-50)
    cases = (("sp ViT-H rank 1 of 2", TIMED_BATCH, 16, 80, 64, 32, 32, 2.8),
             ("flat ViT-B global 40x40", TIMED_BATCH, 12, 64, 40, 40, 0, 3.2),
             ("flat ViT-B windows 14x14", TIMED_BATCH * 9, 12, 64, 14, 14, 0, 3.2))
    for label, b, heads, hd, s, rows, row0, big in cases:
        c, n, nq = heads * hd, s * s, rows * s
        rel_h, rel_w = (randn(2 * s - 1, hd, std=0.3) for _ in range(2))
        if label.startswith("sp"):  # the rank's own qkv, the group's gathered k | v
            own, kv = randn(b, nq, 3 * c), randn(b, n, 2 * c)
            views = lambda: (own[..., :c], kv[..., :c], kv[..., c:])
        else:
            qkv = randn(b, s, s, 3 * c)
            flat = qkv.reshape(b, n, 3 * c)
            views = lambda: (flat[..., :c], flat[..., c:2 * c], flat[..., 2 * c:])
        q, k, v = views()
        fn = lambda: flash_attention_relpos(q, k, v, rel_h, rel_w, s, row0=row0)
        fnp = lambda: relpos_attention_plain(q, k, v, rel_h, rel_w, s, row0)
        shape = f"({b} images x {heads} heads, NQ {nq} from row {row0}, N {n}, hd {hd})"
        _check(f"flash_attention_relpos {label} {shape}", fn(),
               relpos_attention_plain(q.float(), k.float(), v.float(), rel_h, rel_w, s, row0),
               2e-2, errs)
        times[label] = (median_ms(fn), median_ms(fnp, reps=3, warmup=1))
        dev_k = device_ms(fn, "flash_attn_relpos")
        bh = b * heads
        # q.k and p.v over N keys, and q against the S rows of each table its
        # bias needs
        bounds[label] = _bound(4.0 * bh * nq * (n + s) * hd,
                               _nbytes(rel_h, rel_w) + 2 * bh * (2 * nq + 2 * n) * hd)
        if not label.startswith("sp"):
            route = lambda: relpos_grid_attention(qkv, rel_h, rel_w, heads)
            routes[label] = (median_ms(route), device_ms(route, ""))
            _say("kernels", f"relpos_grid_attention {label} (qkv in, output out): "
                            f"{routes[label][0]:.4f} ms by events, {_fmt(routes[label][1])} on "
                            f"the device [{card}]")
        # the library yardstick: the bias as a bf16 (B, H, NQ, N) mask, made
        # beforehand (not timed), q, k, v heads-major
        hm = lambda t: t.reshape(b, -1, heads, hd).transpose(1, 2).reshape(1, bh, -1, hd)
        q4, k4, v4 = (hm(t).contiguous() for t in (q, k, v))
        rh, rw = relpos_score_tables(q4[0], rel_h, rel_w, s, row0=row0)
        mask = (rh[..., :, None] + rw[..., None, :]).reshape(1, bh, nq, n).to(bf)
        del rh, rw
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
        try:
            lib_ev, lib_dev = median_ms(sdpa), device_ms(sdpa, "")
        except RuntimeError as e:  # a yardstick only: no library time for this shape
            _say("kernels", f"scaled_dot_product_attention {label}: refused ({e})")
            lib_ev = lib_dev = None
        device[label] = (dev_k, lib_dev)
        library[label] = lib_ev
        _say("kernels", f"flash_attention_relpos {label}: kernel {times[label][0]:.4f} ms by "
                        f"events, {_fmt(dev_k)} on the device; plain {times[label][1]:.4f} ms; "
                        f"bound {bounds[label][0]:.4f} ms ({bounds[label][1]}); SDPA with a bf16 "
                        f"mask of {_nbytes(mask) / 2 ** 30:.2f} GiB at batch {b}: "
                        f"{_fmt(lib_ev)} by events, {_fmt(lib_dev)} on the device [{card}]")
        del mask, q4, k4, v4
        # logits of |s| ~ 30-50: q and k scaled in place
        if label.startswith("sp"):
            own[..., :c] *= big
            kv[..., :c] *= big
        else:
            qkv[..., :2 * c] *= big
        q, k, v = views()
        qh, kh = (hm(t)[0, :8] for t in (q, k))
        s_max = (qh.float() @ kh[:, :512].float().transpose(1, 2)).abs().max().item() * hd ** -0.5
        _say("kernels", f"flash_attention_relpos {label}: sampled max |q.k/sqrt({hd})| = "
                        f"{s_max:.1f}")
        _check(f"flash_attention_relpos {label} |s|~{s_max:.0f}", fn(),
               relpos_attention_plain(q.float(), k.float(), v.float(), rel_h, rel_w, s, row0),
               2e-2, errs)
        del q, k, v, qh, kh
        if label.startswith("sp"):
            del own, kv
        else:
            del qkv, flat
        torch.cuda.empty_cache()

    # K11d: (x + r, LN(x + r)) at the flat route's tails, ViT-B at the 640 canvas
    rows, c = TIMED_BATCH * 1600, 768
    x, r = randn(rows, c), randn(rows, c)
    sl, bl = 1.0 + randn(c, std=0.1, dtype=torch.float32), randn(c, std=0.1, dtype=torch.float32)
    fn = lambda: tln.layer_norm(x, sl, bl, 1e-6, residual=r)
    fnp = lambda: tln.layer_norm_plain(x, sl, bl, 1e-6, residual=r)
    got, ref = fn(), tln.layer_norm_plain(x.float(), sl, bl, 1e-6, residual=r.float())
    _check(f"layer_norm residual K11d ({rows}x{c}, sum)", got[0], ref[0], 1e-2, errs)
    _check(f"layer_norm residual K11d ({rows}x{c}, LN)", got[1], ref[1], 1e-2, errs)
    times["K11d"] = (median_ms(fn), median_ms(fnp))
    sl16, bl16 = sl.to(torch.bfloat16), bl.to(torch.bfloat16)
    ln_alone = lambda: torch.nn.functional.layer_norm(x, (c,), sl16, bl16, 1e-6)
    device["K11d"] = (device_ms(fn, "layer_norm"), device_ms(ln_alone, "layer_norm"))
    bounds["K11d"] = _bound(9.0 * x.numel(), 4 * _nbytes(x) + _nbytes(sl, bl), "fp32")
    _say("kernels", f"layer_norm residual K11d: kernel {times['K11d'][0]:.4f} ms by events, "
                    f"{_fmt(device['K11d'][0])} on the device; plain {times['K11d'][1]:.4f} ms, "
                    f"bound {bounds['K11d'][0]:.4f} ms ({bounds['K11d'][1]}); no single "
                    f"library call (F.layer_norm of x alone, bf16 weights cast beforehand: "
                    f"{_fmt(device['K11d'][1])} on the device) [{card}]")
    del x, r, got, ref

    # int8_linear at ViT-B's flat global layer, batch 32 (51200 rows)
    from yolo_sam_inference_tpu_torch.ops.quant import quant_rows, quantize_weight

    rows = TIMED_BATCH * 1600
    for label, ci, co, gelu in (("qkv", 768, 2304, False), ("mlp1", 768, 3072, True),
                                ("mlp2", 3072, 768, False)):
        x = randn(rows, ci)
        wq, ws = quantize_weight(randn(ci, co, std=ci ** -0.5))
        bb = randn(co, std=0.1, dtype=torch.float32)
        fn = lambda: tln.int8_linear(x, wq, ws, bb, gelu=gelu)
        fnp = lambda: tln.int8_linear_plain(x, wq, ws, bb, gelu=gelu)
        _check_int8(f"int8_linear {label} ({rows}x{ci} -> {co}{', GELU' if gelu else ''})", fn(),
                    fnp(), errs)
        key = f"int8_linear {label}"
        times[key] = (median_ms(fn), median_ms(fnp, reps=3, warmup=1))
        bounds[key] = _bound(2.0 * rows * ci * co, _nbytes(x, wq, ws, bb) + rows * co * 2, "int8")
        # the library yardstick: the bare int8 product of the same quantised rows
        xq = quant_rows(x.float())[0].to(torch.int8)
        library[key] = _int_mm_ms(xq, wq)
        _say("kernels", f"{key}: kernel {times[key][0]:.4f} ms, plain {times[key][1]:.4f} ms, "
                        f"bound {bounds[key][0]:.4f} ms ({bounds[key][1]}), torch._int_mm (the "
                        f"bare product) {library[key]:.4f} ms [{card}]")
        del x, xq, wq
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library,
            "device": device, "routes": routes}


def _offgrid_slice_phase(card: str, vit_b_pipe) -> dict:
    """The flat route end to end: ViT-B bf16 with ``sam_encoder_size=640``
    (grid 40, window 14 padded to 42) on 640x640 frames with 12 cells, from
    the config-1 pipeline's host trees; the same with ``quant="int8"`` (the
    flat route's qkv, mlp1 and mlp2 on ``int8_linear``), timed in turns with
    bf16; then the 896 canvas (grid 56, window 14 dividing it: the flat route
    without padding on the card) at batch 2, and the 448 and 224 canvases
    (grids 28 and 14: the decoder over 784 and 196 tokens) at batch 2."""
    import dataclasses

    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames

    result: dict = {}
    # random rel-pos tables, qkv biases and LN affines, so the checks see the
    # bias and the pad tokens' keys (the stages of earlier phases are built)
    _randomise_affines(vit_b_pipe.sam_params["vision"], np.random.default_rng(9))
    opts = dataclasses.replace(vit_b_pipe.options, sam_encoder_size=OFF_GRID)
    pipe = _sharing_params(vit_b_pipe, opts)
    t0 = time.perf_counter()
    pipe._stages(OFF_GRID, OFF_GRID)
    _say("slice", f"off-grid 640: stages built (adapt to grid 40 + cast + upload) "
                  f"{time.perf_counter() - t0:.2f} s")
    frames = cell_frames(np.random.default_rng(8), TIMED_BATCH, OFF_GRID)
    # per batch: 12 layers x (qkv + proj + mlp1 + mlp2) GEMMs; K12 at the 4
    # global layers (1600 queries) and the 8 windowed ones (the batch of 14 x
    # 14 windows); LN1 plain at layer 0 and in the residual form after, LN2
    # residual: 1 + 11 + 12; no window attention
    flat = {"gemm_bf16": 48, "flash_attention_relpos": 12, "layer_norm_residual": 23}
    expected = {**DECODER_COUNTS, **flat, "layer_norm": DECODER_COUNTS["layer_norm"] + 1}
    result["launches"], _, out = _drive("off-grid 640 (ViT-B, grid 40, window 14)", pipe,
                                        frames[:SLICE_BATCH], opts.max_det, expected,
                                        by_nq={1600: 4, 196: 8})
    # int8: the flat route's qkv, mlp1 and mlp2 on int8_linear, the
    # projection on gemm_bf16
    pipe8 = _sharing_params(vit_b_pipe, dataclasses.replace(opts, quant="int8"))
    expected8 = {**expected, "gemm_bf16": 12, "int8_linear": 36}
    result["launches int8"], _, _ = _drive("off-grid 640 int8 (ViT-B)", pipe8,
                                           frames[:SLICE_BATCH], opts.max_det, expected8,
                                           by_nq={1600: 4, 196: 8})
    rels, emb32, _ = _embedding_vs_plain("off-grid 640",
                                         {"bf16": (pipe, 0.05), "int8": (pipe8, 0.10)},
                                         frames[:1])
    result["rel_rms"], result["rel_rms int8"] = rels["bf16"], rels["int8"]
    _decoder_vs_plain("off-grid 640", pipe, OFF_GRID, emb32, out["boxes"][:1])
    turns = {"bf16": [], "int8": []}
    for mode, p in (("bf16", pipe), ("int8", pipe8), ("int8", pipe8), ("bf16", pipe)):
        turns[mode].append(_timed(f"off-grid 640 ViT-B {mode} (in turns)", p, frames, card))
    result["ms"], result["ms int8"] = (statistics.median(turns[m]) for m in ("bf16", "int8"))
    result["turns"] = turns
    _say("slice", f"off-grid 640: ms per batch of {TIMED_BATCH} in turns (bf16, int8, int8, "
                  f"bf16): bf16 {[round(v, 2) for v in turns['bf16']]}, int8 "
                  f"{[round(v, 2) for v in turns['int8']]} [{card}]")
    pipe._stage_cache.clear()
    pipe8._stage_cache.clear()

    opts = dataclasses.replace(vit_b_pipe.options, sam_encoder_size=896)
    pipe = _sharing_params(vit_b_pipe, opts)
    result["launches 896"], _, _ = _drive("off-grid 896 (ViT-B, grid 56, window 14, unpadded)",
                                          pipe, frames[:2], opts.max_det, expected,
                                          by_nq={3136: 4, 196: 8})
    rels, emb32, embs = _embedding_vs_plain("off-grid 896", {"bf16": (pipe, 0.05)},
                                            frames[:SP_BATCH])
    result["rel_rms 896"] = rels["bf16"]
    # the sequence-parallel phase at 896 runs these frames on these weights
    result["sp inputs"] = (vit_b_pipe, frames[:SP_BATCH], emb32.cpu(), embs["bf16"])
    pipe._stage_cache.clear()

    # grids of 28 and 14 (window 14 divides them: the flat route, unpadded);
    # K12 at the global layers' 784 or 196 queries and the windows' 196
    for size, by_nq in ((448, {784: 4, 196: 8}), (224, {196: 12})):
        opts = dataclasses.replace(vit_b_pipe.options, sam_encoder_size=size)
        pipe = _sharing_params(vit_b_pipe, opts)
        tag = f"canvas {size} (ViT-B, grid {size // 16}, window 14)"
        result[f"launches {size}"], _, out = _drive(tag, pipe, frames[:2], opts.max_det,
                                                    expected, by_nq=by_nq)
        rels, emb32, _ = _embedding_vs_plain(f"canvas {size}", {"bf16": (pipe, 0.05)},
                                             frames[:1])
        result[f"rel_rms {size}"] = rels["bf16"]
        _decoder_vs_plain(f"canvas {size}", pipe, OFF_GRID, emb32, out["boxes"][:1])
        pipe._stage_cache.clear()
    return result


# The sequence-parallel slices (encoder_parallel="sp" on SP_RANKS ranks):
# config 4 (ViT-H, 1024 canvas) and ViT-B at the 896 canvas, each with the
# launch counts of one rank and batch.
SP_SPECS = {
    # 32 layers x (K1 + proj + two K10) GEMMs on the rank's 32 grid rows, the
    # window attention at the 28 windowed layers (w16), K12 at the 4 global
    # ones on the rank's 2048 queries
    "config 4": {"model": "facebook/sam-vit-huge", "options": {},
                 "expected": {**DECODER_COUNTS, "gemm_bf16": 4 * 32, "window_attn_relpos": 28,
                              "flash_attention_relpos": 4},
                 "by_window": {16: 28}, "by_nq": {2048: 4}},
    # 12 layers x 4 GEMMs on the rank's 28 grid rows; K12 at the 8 windowed
    # layers (the rank's 14 x 14 windows, 196 queries) and at the 4 global
    # ones (28 x 56 = 1568 queries); no window attention
    "896": {"model": "facebook/sam-vit-base", "options": {"sam_encoder_size": 896},
            "expected": {**DECODER_COUNTS, "gemm_bf16": 48, "flash_attention_relpos": 12},
            "by_window": {}, "by_nq": {196: 8, 1568: 4}},
}


def _sp_rank(rank: int, world: int, job: dict) -> None:
    """One rank of a sequence-parallel slice (run by parallel/launch.py in
    a process of its own): the pipeline of ``SP_SPECS[job["spec"]]`` with
    ``encoder_parallel="sp"`` on the parent's parameter trees and frames; its
    launch counts, outputs, embedding and timing go to ``rank<r>.npz`` in
    the job's directory."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import load_tree

    spec = SP_SPECS[job["spec"]]
    trees = load_tree(f"{job['dir']}/params.npz")
    frames = np.load(f"{job['dir']}/frames.npy")
    opts = tengine.PipelineOptions(max_det=16, metric_crop=128, encoder_parallel="sp",
                                   **spec["options"])
    pipe = tengine.CellSegmentationPipeline(spec["model"], options=opts, device="cuda",
                                            params=(trees["yolo"], trees["sam"]))
    del trees
    h, w = frames.shape[1], frames.shape[2]
    pipe._stages(h, w)
    tag = f"sp {job['spec']} rank {rank} of {world}"
    launches, _, out = _drive(tag, pipe, frames, 16, spec["expected"],
                              by_window=spec["by_window"], by_nq=spec["by_nq"])
    with torch.inference_mode():
        emb = pipe._stages(h, w)["embed"](pipe._images_to_device(frames)).cpu().numpy()
    ms = _timed(f"{tag} (two ranks sharing one card: no SP speed)", pipe, frames, job["card"])
    np.savez(f"{job['dir']}/rank{rank}.npz", emb=emb, boxes=out["boxes"], valid=out["valid"],
             mask_crops=out["mask_crops"], ms=np.float64(ms),
             k12=np.int64(launches["flash_attention_relpos"]),
             k12_w14=np.int64(launches.get("flash_attention_relpos nq196", 0)),
             attn=np.int64(launches["window_attn_relpos"]))


def _sp_slice_phase(card: str, spec: str, pipe, frames, emb32, emb16) -> dict:
    """The encoder of ``SP_SPECS[spec]`` sequence-parallel: ``SP_RANKS``
    ranks through parallel/launch.py on ``pipe``'s host trees (written once,
    here, for the ranks to read: ViT-H's numpy init takes 11-15 s), on the
    frames whose single-card bf16 (``emb16``) and fp32 plain (``emb32``)
    embeddings an earlier phase made."""
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
    from yolo_sam_inference_tpu_torch.weights import save_tree

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_tree(f"{tmp}/params.npz", {"yolo": pipe.yolo_params, "sam": pipe.sam_params})
        np.save(f"{tmp}/frames.npy", frames)
        _say("slice", f"sp {spec}: parameter trees written for the ranks in "
                      f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        backend = run_ranks(_sp_rank, SP_RANKS, ({"dir": tmp, "card": card, "spec": spec},))
        _say("slice", f"sp {spec}: backend {backend}, {SP_RANKS} ranks on "
                      f"{torch.cuda.device_count()} card(s); ranks done in "
                      f"{time.perf_counter() - t0:.2f} s")
        ranks = [dict(np.load(f"{tmp}/rank{r}.npz")) for r in range(SP_RANKS)]
    emb = ranks[0]["emb"]
    for r, res in enumerate(ranks[1:], 1):
        if not np.array_equal(res["emb"], emb):
            raise AssertionError(f"sp {spec}: rank {r}'s embedding differs from rank 0's")
    rel16 = float(np.linalg.norm(emb - emb16.numpy()) / np.linalg.norm(emb16.numpy()))
    rel32 = float(np.linalg.norm(emb - emb32.numpy()) / np.linalg.norm(emb32.numpy()))
    same_out = all(np.array_equal(res[k], ranks[0][k]) for res in ranks[1:]
                   for k in ("boxes", "valid", "mask_crops"))
    _say("slice", f"sp {spec}: embedding {emb.shape} equal on all {SP_RANKS} ranks; rel_rms vs the "
                  f"single-card bf16 encoder {rel16:.3e} (bound 0.02), vs the fp32 plain encoder "
                  f"{rel32:.5f} (bound 0.05), max_abs vs single-card "
                  f"{np.abs(emb - emb16.numpy()).max():.3e}; outputs equal across ranks: "
                  f"{same_out}")
    if not (rel16 <= 0.02 and rel32 <= 0.05 and np.isfinite(emb).all()):
        raise AssertionError(f"sp {spec}: the sequence-parallel embedding disagrees with the "
                             f"single-card encoders")
    ms = [float(res["ms"]) for res in ranks]
    _say("slice", f"sp {spec} timed: batch {frames.shape[0]} per rank, ms/batch by rank {ms}: "
                  f"{SP_RANKS} ranks sharing one card, so this is no sequence-parallel speed "
                  f"[{card}]")
    return {"k12": int(ranks[0]["k12"]), "k12_w14": int(ranks[0]["k12_w14"]),
            "attn": int(ranks[0]["attn"]), "rel16": rel16,
            "rel32": rel32, "ms": ms, "backend": backend}


def _mobile_kernel_phase(card: str) -> dict:
    """K13-K16 at TinyViT-5M's batch-32 shapes (512 canvas) against their fp32
    plain versions: the window block at the three stages against the official
    pad-then-LN form (one launch at stages 1 and 2; at stage 3 three, whose
    attention kernel is also checked alone), MBConv at stage 0 and merge2,
    the stride-2 merges merge0 and merge1, the depthwise and the block tail
    at the three stages (the depthwise as the tail calls it: one pass that
    writes y and LN(y)). Beside each kernel's time, the plain version's and,
    where one PyTorch call computes the same function, that call's:
    scaled_dot_product_attention with the bias as a float mask (on windows
    gathered beforehand) for the attention, F.conv2d(groups=C) for the
    depthwise alone (no one call computes the window block); and the device
    time from torch.profiler."""
    import torch
    import torch.nn.functional as F

    from yolo_sam_inference_tpu_torch.bench.common import TINYVIT_STAGES, device_ms, median_ms
    from yolo_sam_inference_tpu_torch.ops import dw_ln_mlp as tdw
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops import mbconv_fused as tmb
    from yolo_sam_inference_tpu_torch.ops import tinyvit_attention as ttv

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(4)

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    b = TIMED_BATCH
    errs: dict = {}
    times: dict = {}
    bounds: dict = {}
    library: dict = {}

    device: dict = {}  # key -> the kernel's device time (torch.profiler), ms

    def report(key):
        lib = f", library {library[key]:.4f} ms" if key in library else ""
        dev_ms = device.get(key, "absent")
        lib += ("" if dev_ms == "absent" else ", device time "
                + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms"))
        _say("kernels", f"{key}: kernel {times[key][0]:.4f} ms, plain {times[key][1]:.4f} ms, "
                        f"bound {bounds[key][0]:.4f} ms ({bounds[key][1]}){lib} [{card}]")

    for si, gs, c, heads, ws in TINYVIT_STAGES:
        x = randn(b, gs, gs, c)
        table = randn(heads, (2 * ws - 1) ** 2, std=0.5)
        ln_s, ln_b = 1.0 + randn(c, std=0.1), randn(c, std=0.5)
        wq, bq = randn(c, 3 * c, std=c ** -0.5), randn(3 * c, std=0.3)
        wp, bp = randn(c, c, std=c ** -0.5), randn(c, std=0.1)
        blk = (table, ln_s, ln_b, wq, bq, wp, bp, heads, ws)
        # the attention's least work: each real query against the window's ws^2
        # keys (pad tokens are keys; pad queries' outputs are never stored)
        attn_flops = b * gs * gs * heads * 4.0 * ws * ws * 32
        fused = (ws, c) in ttv.KERNEL_WIDTHS
        if not fused:
            # stage 3's three launches: their attention kernel alone, beside
            # SDPA with the bias as a float mask on windows gathered beforehand
            qkv = tln.fused_ln_matmul(x, ln_s, ln_b, wq, bq, eps=1e-5)
            pad = ttv.pad_qkv_row(ln_b, wq, bq, bf)
            fn = lambda: ttv.tinyvit_attention(qkv, pad, table, heads, ws)
            fnp = lambda: ttv.tinyvit_attention_plain(qkv, pad, table, heads, ws)
            key = f"tinyvit_attn stage{si} ws{ws}"
            _check(f"tinyvit_attn stage {si} ({b}x{gs}x{gs}x{3 * c}, {heads} heads, ws {ws})",
                   fn(), ttv.tinyvit_attention_plain(qkv.float(), pad.float(), table, heads, ws),
                   2e-2, errs)
            times[key] = (median_ms(fn), median_ms(fnp, reps=5))
            bounds[key] = _bound(attn_flops, _nbytes(qkv, pad, table) + x.numel() * 2)
            device[key] = device_ms(fn, "tinyvit_attn")
            ph = -(-gs // ws) * ws
            grid = pad.reshape(1, 1, 1, -1).repeat(b, ph, ph, 1)
            grid[:, :gs, :gs] = qkv
            win = ttv._windows(grid, ws).reshape(-1, ws * ws, 3, heads, 32).permute(2, 0, 3, 1, 4)
            qw, kw, vw = win[0].contiguous(), win[1].contiguous(), win[2].contiguous()
            mask = table[:, torch.from_numpy(ttv.offset_index(ws)).to(dev)]
            library[key] = median_ms(lambda: F.scaled_dot_product_attention(qw, kw, vw,
                                                                            attn_mask=mask))
            report(key)
            del qkv, grid, win, qw, kw, vw
        # K13: the whole block (one launch at stages 1 and 2, three at stage 3)
        # against the official pad-then-LN form in fp32; beside it the three
        # launches' plain versions (LN + qkv, the attention with the pad-token
        # row, projection + residual in fp32)
        fn = lambda: ttv.tinyvit_window_block(x, *blk)
        fnp = lambda: ttv.tinyvit_window_block_plain(x, *blk)
        route = "one launch" if fused else "gemm_bf16 LN+qkv, tinyvit_attn, proj+residual"
        _check(f"tinyvit_block stage {si} ({b}x{gs}x{gs}x{c}, {heads} heads, ws {ws}: {route})",
               fn(), ttv.tinyvit_window_block_reference(x.float(), *blk), 2e-2, errs)
        key = f"K13 block stage{si}"
        times[key] = (median_ms(fn), median_ms(fnp, reps=5))
        bounds[key] = _bound(8.0 * x.numel() * c + attn_flops,  # 8 C^2 a token: qkv, proj
                             2 * _nbytes(x) + _nbytes(wq, wp, table))
        device[key] = device_ms(fn, "")  # every kernel of the call
        report(key)

        # K16: the depthwise alone (beside F.conv2d), then the tail
        wd, bd = randn(3, 3, c, std=1 / 3), randn(c, std=0.3, dtype=torch.float32)
        w1, b1 = randn(c, 4 * c, std=c ** -0.5), randn(4 * c, std=0.1, dtype=torch.float32)
        w2, b2 = randn(4 * c, c, std=(4 * c) ** -0.5), randn(c, std=0.1, dtype=torch.float32)
        s2, sb2 = 1.0 + randn(c, std=0.1, dtype=torch.float32), randn(c, std=0.1,
                                                                      dtype=torch.float32)
        # the one-pass kernel as the tail calls it: y and LN(y); y within 2% of
        # range of the fp32 plain depthwise, LN(y) within 1% of range of the
        # plain LayerNorm of the kernel's own y
        ln = (s2, sb2, 1e-5)
        fn = lambda: tdw.dw_conv3x3(x, wd, bd, ln=ln)
        fnp = lambda: tdw.dw_conv3x3_plain(x, wd, bd, ln=ln)
        key = f"dw_conv3x3 stage{si}"
        y, ln_y = fn()
        _check(f"dw_conv3x3 stage {si} y ({b}x{gs}x{gs}x{c})", y,
               tdw.dw_conv3x3_plain(x.float(), wd, bd), 2e-2, errs)
        _check(f"dw_conv3x3 stage {si} LN(y)", ln_y,
               tln.layer_norm_plain(y.float(), s2, sb2, 1e-5), 1e-2, errs)
        times[key] = (median_ms(fn), median_ms(fnp))
        bounds[key] = _bound(18.0 * x.numel() + 8.0 * x.numel(),
                             3 * _nbytes(x) + _nbytes(wd, bd, s2, sb2), "fp32")
        device[key] = device_ms(fn, "dw3x3")
        report(key)
        # the same kernel without ln (y alone) beside F.conv2d(groups=C), which
        # computes that function
        fn = lambda: tdw.dw_conv3x3(x, wd, bd)
        fnp = lambda: tdw.dw_conv3x3_plain(x, wd, bd)
        key = f"dw_conv3x3 y only stage{si}"
        _check(f"dw_conv3x3 y only stage {si}", fn(), tdw.dw_conv3x3_plain(x.float(), wd, bd),
               2e-2, errs)
        times[key] = (median_ms(fn), median_ms(fnp))
        bounds[key] = _bound(18.0 * x.numel(), 2 * _nbytes(x) + _nbytes(wd, bd), "fp32")
        device[key] = device_ms(fn, "dw3x3")
        xc = x.permute(0, 3, 1, 2)  # a channels-last view of the same tensor
        kc, bc = wd.permute(2, 0, 1)[:, None].contiguous(), bd.to(bf)
        library[key] = median_ms(lambda: F.conv2d(xc, kc, bc, padding=1, groups=c))
        report(key)
        del y, ln_y
        tail = (wd, bd, s2, sb2, w1, b1, w2, b2)
        fn = lambda: tdw.dw_ln_mlp(x, *tail)
        fnp = lambda: tdw.dw_ln_mlp(x, *tail, gemm=tln.gemm_plain, dw=tdw.dw_conv3x3_plain)
        _check(f"dw_ln_mlp tail stage {si} (dw_conv3x3, gemm_bf16 LN+mlp1+GELU, mlp2+y)", fn(),
               tdw.dw_ln_mlp(x.float(), *tail, gemm=tln.gemm_plain, dw=tdw.dw_conv3x3_plain),
               2e-2, errs)
        key = f"K16 tail stage{si}"
        times[key] = (median_ms(fn), median_ms(fnp, reps=5))
        bounds[key] = _bound(18.0 * x.numel() + 16.0 * x.numel() * c,
                             2 * _nbytes(x) + _nbytes(wd, w1, w2))
        report(key)
        del x
        torch.cuda.empty_cache()

    # K14 and K15 (one kernel source): (name, input, E, Co, stride, residual)
    cases = (("mbconv stage0", (b, 128, 128, 64), 256, 64, 1, True),
             ("mbconv merge2", (b, 32, 32, 160), 320, 320, 1, False),
             ("patch_merge merge0", (b, 128, 128, 64), 128, 128, 2, False),
             ("patch_merge merge1", (b, 64, 64, 128), 160, 160, 2, False))
    for key, shape, e, co, stride, residual in cases:
        x = randn(*shape)
        c = shape[-1]
        w = (randn(c, e, std=c ** -0.5), randn(e, std=0.3, dtype=torch.float32),
             randn(3, 3, e, std=1 / 3), randn(e, std=0.3, dtype=torch.float32),
             randn(e, co, std=e ** -0.5), randn(co, std=0.3, dtype=torch.float32))
        if stride == 2:
            fn = lambda: tmb.patch_merge_block(x, *w)
        else:
            fn = lambda: tmb.mbconv_block(x, *w, residual=residual)
        fnp = lambda: tmb.mbconv_plain(x, *w, stride=stride, residual=residual)
        out = fn()
        _check(f"{key} ({'x'.join(map(str, shape))} -> E {e} -> {'x'.join(map(str, out.shape))})",
               out, tmb.mbconv_plain(x.float(), *w, stride=stride, residual=residual), 2e-2,
               errs)
        times[key] = (median_ms(fn), median_ms(fnp, reps=5))
        pix_in, pix_out = x.numel() // c, out.numel() // co
        bounds[key] = _bound(2.0 * pix_in * c * e + pix_out * (18.0 * e + 2.0 * e * co),
                             _nbytes(x, out, *w))
        device[key] = device_ms(fn, "mbconv")
        report(key)
        if key in ("mbconv stage0", "patch_merge merge0", "patch_merge merge1"):
            # the compute="bf16" instantiation: against its bf16-compute plain
            # version, and against fp32 plain within the JAX package's bound
            # for the mode (max 8%, mean 1% of max|ref|)
            mode = {"compute": "bf16"}
            fn16 = ((lambda: tmb.patch_merge_block(x, *w, **mode)) if stride == 2 else
                    (lambda: tmb.mbconv_block(x, *w, residual=residual, **mode)))
            fnp16 = lambda: tmb.mbconv_plain(x, *w, stride=stride, residual=residual, **mode)
            kernel = "mbconv_bf16" if stride == 1 else "patch_merge_bf16"
            got = fn16()
            _check(f"{kernel} {key.split()[1]} (vs its bf16-compute plain version)", got, fnp16(),
                   2e-2, errs)
            ref = tmb.mbconv_plain(x.float(), *w, stride=stride, residual=residual)
            d, scale = (got.float() - ref).abs(), ref.abs().max().item()
            ok = d.max().item() <= 0.08 * scale and d.mean().item() <= 0.01 * scale
            _say("kernels", f"{kernel} vs fp32 plain: max {d.max().item():.5g}, mean "
                            f"{d.mean().item():.5g} (bounds {0.08 * scale:.5g}, "
                            f"{0.01 * scale:.5g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kernel}: outside the JAX bound of the bf16 mode")
            bkey = f"{key} bf16"
            # in turns with the fp32 instantiation: fp32, bf16, bf16, fp32
            t32 = [times[key][0]]
            t16 = [median_ms(fn16), median_ms(fn16)]
            t32.append(median_ms(fn))
            times[bkey] = (statistics.median(t16), median_ms(fnp16, reps=5))
            bounds[bkey] = bounds[key]
            device[bkey] = device_ms(fn16, "mbconv")
            report(bkey)
            _say("kernels", f"{key}: fp32 instantiation ms {[round(v, 4) for v in t32]}, bf16 "
                            f"{[round(v, 4) for v in t16]} (in turns) [{card}]")
            del got, ref, d
        del x, out
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library,
            "device": device}


def _conv_kernel_phase(card: str) -> dict:
    """K17 (``conv2d_act``) at its batch-32 shapes against its fp32 plain
    version, within 2% of the output range; beside its time (and its device
    time from torch.profiler), the plain version's, the bound and the library
    call: ``F.conv2d`` with its bias on
    channels-last bf16 (the activation left apart, as ``addmm`` for K1;
    for k = 2 with padding 1, whose first H x W outputs are K17's). The C2f
    bottleneck's input is a channel slice (pixel stride 64), as on the path."""
    import torch
    import torch.nn.functional as F

    from yolo_sam_inference_tpu_torch.bench.common import CONV_SHAPES, device_ms, median_ms
    from yolo_sam_inference_tpu_torch.ops import conv2d_fused as tcv

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(17)

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g) * std).to(dev, dtype)

    b = TIMED_BATCH
    errs: dict = {}
    times: dict = {}
    bounds: dict = {}
    library: dict = {}
    device: dict = {}  # the kernel's device time (torch.profiler), ms
    for key, (h, w, ci), co, k, stride, act, has_bias, sliced in CONV_SHAPES:
        x = randn(b, h, w, 2 * ci)[..., ci:] if sliced else randn(b, h, w, ci)
        wt = randn(k, k, ci, co, std=(k * k * ci) ** -0.5)
        bias = randn(co, std=0.3, dtype=torch.float32) if has_bias else None
        fn = lambda: tcv.conv2d_act(x, wt, bias, k, stride, act)
        fnp = lambda: tcv.conv2d_act_plain(x, wt, bias, k, stride, act)
        out = fn()
        _check(f"conv2d_act {key} ({b}x{h}x{w}x{ci} -> {'x'.join(map(str, out.shape))}, k {k}, "
               f"stride {stride}, {act}{'' if has_bias else ', no bias'})", out,
               tcv.conv2d_act_plain(x.float(), wt, bias, k, stride, act), 2e-2, errs)
        times[key] = (median_ms(fn), median_ms(fnp, reps=5))
        bounds[key] = _bound(2.0 * out.numel() * k * k * ci, _nbytes(x, wt, bias, out))
        xc = x.permute(0, 3, 1, 2)  # a channels-last view of the same tensor
        wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bc = None if bias is None else bias.to(bf)
        library[key] = median_ms(lambda: F.conv2d(xc, wc, bc, stride, 1))
        device[key] = device_ms(fn, "conv2d_act")
        dev_ms = "not measured" if device[key] is None else f"{device[key]:.4f} ms"
        _say("kernels", f"conv2d_act {key}: kernel {times[key][0]:.4f} ms (device time "
                        f"{dev_ms}), plain {times[key][1]:.4f} ms, bound {bounds[key][0]:.4f} ms "
                        f"({bounds[key][1]}), F.conv2d bf16 {library[key]:.4f} ms [{card}]")
        del x, wt, out, xc, wc
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library, "device": device}


def _slice_phase(card: str) -> dict:
    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.pipeline.engine import (
        CellSegmentationPipeline,
        PipelineOptions,
    )

    t0 = time.perf_counter()
    opts = PipelineOptions(max_det=16, metric_crop=128)
    pipe = CellSegmentationPipeline(
        sam_model_type="facebook/sam-vit-base", options=opts, device="cuda", seed=0
    )
    pipe._stages(FRAME, FRAME)
    _say("slice", f"pipeline built (ViT-B init + adapt + upload): {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    frames = cell_frames(rng, TIMED_BATCH, FRAME)

    # per batch: 12 layers x (qkv + proj + 2 MLP) GEMMs; 12 attentions, 8 at
    # window 16 and the 4 global ones at 32; the decoder's (DECODER_COUNTS)
    launches, _, out = _drive("config 1", pipe, frames[:SLICE_BATCH], opts.max_det,
                              {**DECODER_COUNTS, "gemm_bf16": 48, "window_attn_relpos": 12},
                              by_window={16: 8, 32: 4})

    _, emb32, _ = _embedding_vs_plain("config 1", {"bf16": (pipe, 0.05)}, frames[:1])
    _decoder_vs_plain("config 1", pipe, FRAME, emb32, out["boxes"][:1])

    ms = _timed("config 1", pipe, frames, card)
    return {"launches": launches, "ms_per_batch": ms, "pipe": pipe, "frames": frames}


def _fused_slice_phase(card: str, pipe, frames, default_ms: float) -> dict:
    """Config 1 with ``conv2d_fused=True`` over ``pipe``'s parameters and
    frames: YOLOv8n's 39 dense convs and the ViT neck's 3x3 on K17."""
    import dataclasses

    fpipe = _sharing_params(pipe, dataclasses.replace(pipe.options, conv2d_fused=True))
    tag = "config 1 conv2d_fused"
    launches, _, _ = _drive(tag, fpipe, frames[:SLICE_BATCH], fpipe.options.max_det,
                            {**DECODER_COUNTS, "gemm_bf16": 48, "window_attn_relpos": 12,
                             "conv2d_act": 40}, by_window={16: 8, 32: 4})
    yolo_rel = _yolo_vs_plain(tag, {"conv2d_fused": fpipe, "default": pipe}, frames[:1])
    yolo_ms = _yolo_forward_ms(tag, {"default": pipe, "conv2d_fused": fpipe}, frames, card)
    _embedding_vs_plain(tag, {"bf16": (fpipe, 0.05)}, frames[:1])
    # in turns with the default route (its first pass ran before the conv kernels' phase)
    turns = {"default": [default_ms], "conv2d_fused": []}
    for mode, p in (("conv2d_fused", fpipe), ("default", pipe), ("conv2d_fused", fpipe)):
        turns[mode].append(_timed(f"config 1 ({mode} route, in turns)", p, frames, card))
    ms = statistics.median(turns["conv2d_fused"])
    _say("slice", f"{tag}: ms per batch of {frames.shape[0]} in turns (default, then after the "
                  f"conv kernels fused, default, fused): default "
                  f"{[round(v, 2) for v in turns['default']]}, conv2d_fused "
                  f"{[round(v, 2) for v in turns['conv2d_fused']]} [{card}]")
    fpipe._stage_cache.clear()
    return {"launches": launches, "ms_per_batch": ms, "yolo_rel_rms": yolo_rel,
            "yolo_ms": yolo_ms, "turns": turns}


def _directory_phase(card: str, pipe) -> dict:
    """The disk-to-CSV path at config 1 over ``pipe``'s stages: DIR_FILES
    mode-L PNG frames through ``process_directory`` (batches of TIMED_BATCH,
    counts set to 0 just before and read just after), each image's rows
    against ``process_batch_arrays`` on the same batch, the bitpack round
    trip, ``fused_call_chunked`` against ``fused_call``, the CSVs read back,
    the visualisations of 4 files; then the bench entry's line."""
    import copy
    import csv
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench import e2e
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, median_ms, write_png
    from yolo_sam_inference_tpu_torch.io import images as timages
    from yolo_sam_inference_tpu_torch.io import png_native
    from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS
    from yolo_sam_inference_tpu_torch.pipeline.engine import _pack_csv_outputs, pack_bits
    from yolo_sam_inference_tpu_torch.reporting import save_results_to_csv

    # the same stages and weights; batch_size reaches only the loader
    dpipe = copy.copy(pipe)
    dpipe.options = dataclasses.replace(pipe.options, batch_size=TIMED_BATCH)
    dpipe._slots, dpipe._slot_next = [], 0
    dev = dpipe.device
    result: dict = {}
    phase_t0 = t0 = time.perf_counter()
    gray = cell_frames(np.random.default_rng(1), DIR_FILES, FRAME)[..., 0]
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "in"
        src.mkdir()
        for i, frame in enumerate(gray):
            write_png(src / f"f_{i:03d}.png", frame)
        _say("directory", f"{DIR_FILES} mode-L PNGs of {FRAME}x{FRAME} made and written in "
                          f"{time.perf_counter() - t0:.2f} s")
        # warm at the loader's one-channel shape: the stage path and one overlapped
        # batch; and the PNG decoder's one-time g++ build
        png_native.library()
        dpipe.process_batch_arrays(gray[:TIMED_BATCH], fetch_masks=False, fetch_outputs=False)
        dpipe._fetch_outputs(dpipe._dispatch_batch(gray[:TIMED_BATCH], fetch_masks=False))
        torch.cuda.synchronize()

        # PIL hidden from the decoder: a file that needed it would be skipped
        pil, timages._PILImage = timages._PILImage, None
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        try:
            batch = dpipe.process_directory(src, Path(td) / "out", progress=False)
            torch.cuda.synchronize()
        finally:
            timages._PILImage = pil
        secs = time.perf_counter() - t0
        stats = dpipe.last_directory_stats
        passes = stats["n_batches"] + stats["n_sample_batches"]
        per_batch = {**DECODER_COUNTS, "gemm_bf16": 48, "window_attn_relpos": 12}
        result["launches"] = _read_counts(
            "directory", wrappers, {k: v * passes for k, v in per_batch.items()},
            by_window={16: 8 * passes, 32: 4 * passes})
        result["ips"] = DIR_FILES / secs
        result["stats"] = stats
        _say("directory", f"process_directory (PNG decode without PIL): {DIR_FILES} files in "
                          f"{secs:.3f} s = "
                          f"{result['ips']:.2f} img/s; last_directory_stats {json.dumps(stats)} "
                          f"[{card}]")
        if len(batch.results) != DIR_FILES or stats["n_images"] != DIR_FILES:
            raise AssertionError(f"directory: {len(batch.results)} results, expected {DIR_FILES}")

        # each image's rows against the synced stage API on the same batch
        by_name = {Path(r.image_path).name: r for r in batch.results}
        worst = 0.0
        for b0 in range(0, DIR_FILES, TIMED_BATCH):
            out = dpipe.process_batch_arrays(gray[b0:b0 + TIMED_BATCH], fetch_masks=False)
            for j in range(TIMED_BATCH):
                res = by_name[f"f_{b0 + j:03d}.png"]
                kept = np.flatnonzero(out["valid"][j])
                if res.num_cells != len(kept):
                    raise AssertionError(f"directory: f_{b0 + j:03d}.png has {res.num_cells} "
                                         f"cells, process_batch_arrays {len(kept)}")
                for row, k in zip(res.cell_metrics, kept):
                    for key, got in row.items():
                        want = float(out["metrics"][key][j, k])
                        want = float(np.round(want)) if key in INT_METRIC_KEYS else want
                        err = abs(got - want)
                        worst = max(worst, err / (1e-5 + 1e-5 * abs(want)))
                        if not err <= 1e-5 + 1e-5 * abs(want):
                            raise AssertionError(f"directory: f_{b0 + j:03d}.png {key} {got} "
                                                 f"against {want}")
        _say("directory", f"rows equal process_batch_arrays on the same batches "
                          f"({sum(r.num_cells for r in batch.results)} cells; worst error "
                          f"{worst:.3f} of rtol=1e-5, atol=1e-5)")

        # the CSVs parse back to the same rows
        save_results_to_csv(batch, Path(td))
        with open(Path(td) / "cell_metrics.csv", newline="") as f:
            parsed = list(csv.DictReader(f))
        with open(Path(td) / "processing_times.csv", newline="") as f:
            timing_rows = list(csv.DictReader(f))
        same = len(parsed) == len(batch.metrics_data) and all(
            set(row) == set(want) and all(
                (row[k] == str(v)) if isinstance(v, (str, int)) else float(row[k]) == v
                for k, v in want.items())
            for row, want in zip(parsed, batch.metrics_data))
        if not (same and len(timing_rows) == DIR_FILES):
            raise AssertionError("directory: the CSVs do not read back to the rows")
        _say("directory", f"cell_metrics.csv ({len(parsed)} rows) and processing_times.csv "
                          f"({len(timing_rows)} rows) read back to the same rows")

        # the visualisations of the first 4 files (the synced stage path: one batch)
        files = sorted(src.iterdir())[:4]
        vis = dpipe.process_directory(src, Path(td) / "vis", save_visualizations=True,
                                      image_paths=files, progress=False)
        run_dir = Path(td) / "vis" / dpipe.run_id
        dirs = ["1_original_images", "2_yolo_detections", "3_processed_masks",
                "3_processed_masks/masks", "3_processed_masks/overlay_images",
                "3_processed_masks/convex_hull_overlay", "4_combined_visualization"]
        missing = [d for d in dirs if not (run_dir / d).is_dir()]
        n_masks = len(list((run_dir / "3_processed_masks/masks").glob("*.tiff")))
        if missing or n_masks != sum(r.num_cells for r in vis.results):
            raise AssertionError(f"directory: visualisations missing {missing}, {n_masks} masks")
        _say("directory", f"visualisations of {len(files)} files: the seven directories, "
                          f"{n_masks} mask TIFFs")

    # the bitpack round trip, and the fetch before (bool crops whole, the
    # parent's) and after (bitpack into a pinned slot, event, unpack)
    frames = torch.from_numpy(gray[:2 * TIMED_BATCH]).to(dev)
    outputs = dpipe.fused_call(frames[:TIMED_BATCH])
    crops = outputs[3]
    want = crops.cpu().numpy()
    if not (pack_bits(crops).cpu().numpy() == np.packbits(want, axis=-1)).all():
        raise AssertionError("directory: pack_bits differs from np.packbits")
    got = dpipe._fetch_outputs(dpipe._start_fetch(dpipe._acquire_slot(), outputs, True))
    if not np.array_equal(got["mask_crops"], want):
        raise AssertionError("directory: the bitpack round trip differs from the bool crops")
    def whole():
        _pack_csv_outputs(*outputs[:3], *outputs[4:]).cpu().numpy()
        crops.cpu().numpy()

    def packed():
        dpipe._fetch_outputs(dpipe._start_fetch(dpipe._acquire_slot(), outputs, True))

    result["fetch_ms"] = {"whole": median_ms(whole, reps=10), "packed": median_ms(packed, reps=10)}
    _say("slice", f"config 1 fetch ms per batch of {TIMED_BATCH} (rows + crops, "
                  f"{tuple(crops.shape)}): bool crops whole {result['fetch_ms']['whole']:.3f}, "
                  f"bitpacked into a pinned slot {result['fetch_ms']['packed']:.3f} [{card}]")
    _say("directory", f"bitpack round trip equals the bool crops ({tuple(crops.shape)})")

    # fused_call_chunked on 2 x TIMED_BATCH frames against two fused_calls
    chunked = dpipe.fused_call_chunked(frames.reshape(2, TIMED_BATCH, FRAME, FRAME))
    for n in range(2):
        single = dpipe.fused_call(frames[n * TIMED_BATCH:(n + 1) * TIMED_BATCH])
        pairs = list(zip(chunked[:5], single[:5])) + [(chunked[5][k], single[5][k])
                                                      for k in single[5]]
        if not all(torch.equal(c[n], s) for c, s in pairs):
            raise AssertionError(f"directory: fused_call_chunked batch {n} differs from fused_call")
    _say("directory", f"fused_call_chunked on 2 x {TIMED_BATCH} frames equals two fused_calls")

    # fused_call alone, frames on the card, outputs left there
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        dpipe.fused_call(frames[:TIMED_BATCH])
    torch.cuda.synchronize()
    result["fused_ips"] = TIMED_BATCH * 10 / (time.perf_counter() - t0)
    _say("directory", f"fused_call: {result['fused_ips']:.2f} img/s at batch {TIMED_BATCH} "
                      f"[{card}]")
    del frames, outputs, chunked, crops

    # the bench entry at this cell, its directory leg over DIR_FILES files
    knobs = {"BENCH_BATCH": str(TIMED_BATCH), "BENCH_ITERS": str(TIMED_ITERS),
             "BENCH_E2E": "1", "BENCH_E2E_FILES": str(DIR_FILES)}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        result["bench"] = e2e.run("cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    _say("directory", f"bench/e2e.py at {json.dumps(knobs)}: {json.dumps(result['bench'])}")
    _say("directory", f"phase done in {time.perf_counter() - phase_t0:.1f} s")
    torch.cuda.empty_cache()
    return result


def _yolo_forward_ms(tag: str, pipes: dict, frames, card: str) -> dict:
    """{mode: [median ms, ...]}: YOLOv8n's forward alone on the letterboxed
    bf16 batch (CUDA events), each pipeline's in turns (a, b, b, a)."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.ops.preprocess import letterbox_batch

    h, w = frames.shape[1], frames.shape[2]
    modes = list(pipes)
    res = {mode: [] for mode in modes}
    with torch.inference_mode():
        first = pipes[modes[0]]
        lb, _, _ = letterbox_batch(torch.from_numpy(frames).cuda(),
                                   first.options.yolo_size_for(h, w))
        lb = lb.to(torch.bfloat16)
        for mode in modes + modes[::-1]:
            yolo = pipes[mode]._stages(h, w)["yolo"]
            res[mode].append(median_ms(lambda: yolo(lb), reps=10))
    _say("slice", f"{tag}: YOLOv8n forward alone, batch {frames.shape[0]}, ms in turns: "
                  + ", ".join(f"{m} {[round(v, 4) for v in res[m]]}" for m in modes) + f" [{card}]")
    return res


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
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

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

    tiled = "huge" in model  # ViT-H's int8 tail is K11b, ViT-L's K11a
    common = {**DECODER_COUNTS, "window_attn_relpos": layers}
    # bf16: per layer K1 + projection + two K10 GEMMs; int8: the projection on
    # gemm_bf16, K11c, and the K11a or K11b tail
    expected = {
        "bf16": {**common, "gemm_bf16": 4 * layers},
        "int8": {**common, "gemm_bf16": layers, "fused_ln_matmul_int8": layers,
                 "fused_ln_mlp_tiled_int8" if tiled else "fused_ln_mlp_int8": layers},
    }
    result: dict = {"launches": {}, "ms_per_batch": {}}
    for mode, pipe in pipes.items():
        result["launches"][mode], _, _ = _drive(f"{short} {mode}", pipe, frames[:SLICE_BATCH],
                                                max_det, expected[mode],
                                                by_window={16: layers - 4, 32: 4})

    # the embedding of one frame against the fp32 plain encoder on the same
    # bf16-rounded float weights (the int8 path quantises those same weights)
    result["rel_rms"], _, _ = _embedding_vs_plain(
        short, {"bf16": (pipe_b, 0.05), "int8": (pipes["int8"], 0.10)}, frames[:1])

    for mode, pipe in pipes.items():
        result["ms_per_batch"][mode] = _timed(f"{short} {mode} (max_det {max_det})", pipe, frames,
                                              card)
    for pipe in pipes.values():
        pipe._stage_cache.clear()  # the device weights go; the host trees stay for phase 8
    result["pipe"] = pipe_b
    del pipes
    torch.cuda.empty_cache()
    return result


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its launch count goes under."""
    from yolo_sam_inference_tpu_torch.ops import conv2d_fused as tcv
    from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
    from yolo_sam_inference_tpu_torch.ops import dw_ln_mlp as tdw
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops import mbconv_fused as tmb
    from yolo_sam_inference_tpu_torch.ops import tinyvit_attention as ttv
    from yolo_sam_inference_tpu_torch.ops.flash_attention import (
        flash_attention_relpos,
        window_attention,
    )
    from yolo_sam_inference_tpu_torch.ops.hull_support import support_points
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop

    return {"gemm_bf16": tln.gemm_bf16, "window_attn_relpos": window_attention,
            "flash_attention_relpos": flash_attention_relpos,
            "fused_ln_matmul_int8": tln.fused_ln_matmul_int8,
            "fused_ln_mlp_int8": tln.fused_ln_mlp_int8,
            "fused_ln_mlp_tiled_int8": tln.fused_ln_mlp_tiled_int8,
            "int8_linear": tln.int8_linear,
            "tinyvit_block": ttv.tinyvit_window_block, "tinyvit_attn": ttv.tinyvit_attention,
            "mbconv_block": tmb.mbconv_block,
            "patch_merge_block": tmb.patch_merge_block, "dw_conv3x3": tdw.dw_conv3x3,
            "layer_norm": tln.layer_norm, "keys_stream": dec.keys_stream,
            "t2i_attend": dec.t2i_attend, "t2i_combine": dec.t2i_combine,
            "window_crop": window_crop, "hull_support": support_points,
            "conv2d_act": tcv.conv2d_act}


def _reset_counts() -> dict:
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    wrappers["window_attn_relpos"].by_window = {}
    wrappers["flash_attention_relpos"].by_nq = {}
    wrappers["layer_norm"].residual_launches = 0
    wrappers["mbconv_block"].bf16_launches = 0
    wrappers["patch_merge_block"].bf16_launches = 0
    return wrappers


def _read_counts(tag: str, wrappers: dict, expected: dict, by_window=None, by_nq=None) -> dict:
    """The launch counts since the reset; every kernel not in ``expected``
    must have run 0 times (the residual LayerNorm, K11d, counts as
    ``layer_norm_residual``; the compute="bf16" instantiations of K14 and
    K15 as ``mbconv_block_bf16`` and ``patch_merge_block_bf16`` too), and
    the window attention's counts by window
    and K12's by query count must match. The returned counts add K12's by
    query count as ``flash_attention_relpos nq<NQ>`` and the window
    attention's by window as ``window_attn_relpos w<w>`` (windows of 16 run
    on one kernel, the others on K12's)."""
    launches = {name: w.launches for name, w in wrappers.items()}
    launches["layer_norm_residual"] = wrappers["layer_norm"].residual_launches
    for name in ("mbconv_block", "patch_merge_block"):
        launches[f"{name}_bf16"] = wrappers[name].bf16_launches
    windows = dict(wrappers["window_attn_relpos"].by_window)
    nqs = dict(wrappers["flash_attention_relpos"].by_nq)
    _say("slice", f"{tag}: launches {({k: v for k, v in launches.items() if v})}, attention by "
                  f"window {windows}, K12 by query count {nqs}")
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(f"{tag}: {name} launched {n} times, expected "
                                 f"{expected.get(name, 0)}")
    if by_window is not None and windows != by_window:
        raise AssertionError(f"{tag}: attention launches by window {windows}, expected {by_window}")
    if by_nq is not None and nqs != by_nq:
        raise AssertionError(f"{tag}: K12 launches by query count {nqs}, expected {by_nq}")
    launches.update({f"flash_attention_relpos nq{nq}": c for nq, c in nqs.items()})
    launches.update({f"window_attn_relpos w{w}": c for w, c in windows.items()})
    return launches


def _drive(tag: str, pipe, frames, max_det: int, expected: dict, by_window=None,
           by_nq=None) -> tuple:
    """One batch through process_batch_arrays with every count set to 0 just
    before and read just after; output shapes and finite values checked."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS

    wrappers = _reset_counts()
    t0 = time.perf_counter()
    out = pipe.process_batch_arrays(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts(tag, wrappers, expected, by_window, by_nq)
    b = frames.shape[0]
    cm = min(pipe.options.metric_crop, frames.shape[1], frames.shape[2])
    if out["mask_crops"].shape != (b, max_det, cm, cm) or out["boxes"].shape != (b, max_det, 4):
        raise AssertionError(f"{tag}: output shapes {out['mask_crops'].shape}, "
                             f"{out['boxes'].shape}")
    finite = [np.isfinite(out["boxes"]).all(), np.isfinite(out["scores"]).all()]
    finite += [np.isfinite(out["metrics"][key]).all() and out["metrics"][key].shape == (b, max_det)
               for key in METRIC_KEYS]
    if not all(finite):
        raise AssertionError(f"{tag}: non-finite or misshapen boxes, scores or metrics")
    if (out["metrics"]["area"][~out["valid"]] != 0).any():
        raise AssertionError(f"{tag}: invalid detections carry a nonzero area")
    _say("slice", f"{tag}: batch {b} in {secs:.2f} s (first run at this shape); outputs ok, "
                  f"{int(out['valid'].sum())} valid cells")
    return launches, secs, out


def _embedding_vs_plain(tag: str, pipes: dict, frames, encoder_expected=None) -> tuple:
    """({mode: relative RMS}, fp32 embedding, {mode: the pipeline's embedding
    on the host}): the embedding of ``frames`` by
    each pipeline of ``pipes`` ({mode: (pipe, bound)}, all over one host
    tree) against the fp32 plain encoder, built once on the first one's
    bf16-rounded weights (an int8 pipeline quantises those same weights);
    with ``encoder_expected``, the launch counts of the first pipeline's
    encoder alone are checked too."""
    import torch

    from yolo_sam_inference_tpu_torch.ops.preprocess import sam_preprocess_batch
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    h, w = frames.shape[1], frames.shape[2]
    first = next(iter(pipes.values()))[0]
    scfg = first._stages(h, w)["scfg"]
    tree = tengine._round_floating(first._sam_params_for(scfg), torch.bfloat16)
    _, sam32 = from_jax_params(None, tree, "cuda", torch.float32, sam_config=scfg)
    del tree
    img = torch.from_numpy(frames).cuda()
    with torch.inference_mode():
        pix, _, _ = sam_preprocess_batch(img, scfg.image_size)
        emb32 = sam32.vision(pix, plain=True)
    del sam32
    torch.cuda.empty_cache()
    rels, embs = {}, {}
    for mode, (pipe, bound) in pipes.items():
        with torch.inference_mode():
            wrappers = _reset_counts()
            emb = pipe._stages(h, w)["sam"].vision(pix.to(torch.bfloat16)).float()
            torch.cuda.synchronize()
        if encoder_expected is not None and pipe is first:
            _read_counts(f"{tag} {mode} encoder alone", wrappers, encoder_expected)
        rels[mode] = rel = ((emb - emb32).norm() / emb32.norm()).item()
        _say("slice", f"{tag} {mode} embedding vs fp32 plain ({frames.shape[0]} frame(s), "
                      f"{tuple(emb32.shape)}): rel_rms={rel:.5f} (bound {bound}), max_abs="
                      f"{(emb - emb32).abs().max().item():.5f}, "
                      f"max|ref|={emb32.abs().max().item():.4f}")
        if not (rel <= bound and torch.isfinite(emb).all()):
            raise AssertionError(f"{tag} {mode}: embedding disagrees with the fp32 plain encoder")
        embs[mode] = emb.cpu()
    return rels, emb32, embs


def _yolo_vs_plain(tag: str, pipes: dict, frames) -> dict:
    """{mode: the largest relative RMS over the three levels}: the raw YOLO
    level maps of ``frames`` by each pipeline of ``pipes`` ({mode: pipe}, one
    host tree) against ``YoloV8(plain=True)`` in fp32 (TF32 off) on the same
    bf16-rounded weights; each within 5%."""
    import torch

    from yolo_sam_inference_tpu_torch.ops.preprocess import letterbox_batch
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    torch.backends.cudnn.allow_tf32 = False  # the fp32 oracle stays fp32
    first = next(iter(pipes.values()))
    h, w = frames.shape[1], frames.shape[2]
    tree = tengine._round_floating(first.yolo_params, torch.bfloat16)
    yolo32, _ = from_jax_params(tree, None, "cuda", torch.float32, yolo_config=first.yolo_config)
    size = first.options.yolo_size_for(h, w)
    with torch.inference_mode():
        lb, _, _ = letterbox_batch(torch.from_numpy(frames).cuda(), size)
        want = yolo32(lb.float(), plain=True)
    rels = {}
    for mode, pipe in pipes.items():
        with torch.inference_mode():
            got = pipe._stages(h, w)["yolo"](lb.to(torch.bfloat16))
        per_level = [((g.float() - r).norm() / r.norm()).item() for g, r in zip(got, want)]
        rels[mode] = max(per_level)
        _say("slice", f"{tag} YOLO raw maps ({mode}) vs fp32 plain ({frames.shape[0]} frame(s), "
                      f"{[tuple(r.shape) for r in want]}): rel_rms by level "
                      f"{[round(v, 5) for v in per_level]} (bound 0.05)")
        if not (rels[mode] <= 0.05 and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"{tag} {mode}: YOLO maps disagree with the fp32 plain YOLO")
    del yolo32
    return rels


def _decoder_vs_plain(tag: str, pipe, size: int, emb32, boxes) -> None:
    """The bf16 decoder on the card (keys_stream, t2i_attend, t2i_combine)
    against the fp32 plain decoder on the host, on one frame's fp32 plain
    embedding and its box prompts; then window_crop of that keys grid at the
    pipeline's crop size against its plain version (a copy: exact). Both
    decoders hold the same bf16-rounded weights: the pipeline casts every
    parameter, the Fourier matrix too (its entries are O(400), so a bf16
    rounding moves the positional encodings by radians; the JAX engine does
    the same)."""
    import math

    import torch

    from yolo_sam_inference_tpu_torch.models.sam import SamMaskDecoder, SamPromptEncoder
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop, window_crop_plain
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    st = pipe._stages(size, size)
    scfg = st["scfg"]
    tree = tengine._round_floating({k: pipe.sam_params[k] for k in ("prompt", "decoder",
                                                                    "shared_pe")}, torch.bfloat16)
    prompt = SamPromptEncoder(tree["prompt"], tree["shared_pe"], scfg)
    decoder = SamMaskDecoder(tree["decoder"], scfg)
    boxes = torch.from_numpy(boxes) * (scfg.image_size / size)  # encoder-input pixels
    with torch.inference_mode():
        sparse = st["sam"].prompt.boxes(boxes.cuda()).to(torch.bfloat16)
        _, hyper16, grid16 = st["sam"].mask_decoder_tokens(emb32.to(torch.bfloat16), sparse)
        _, hyper32, grid32 = decoder.tokens(emb32.cpu(), prompt.boxes(boxes), prompt.image_pe(),
                                            prompt.no_mask)
    for name, got, want in (("keys grid", grid16, grid32), ("hypernetwork out", hyper16, hyper32)):
        got = got.float().cpu()
        rel = ((got - want).norm() / want.norm()).item()
        _say("slice", f"{tag} decoder {name} bf16 kernels vs fp32 plain (1 frame, "
                      f"{boxes.shape[1]} prompts, {tuple(want.shape)}): rel_rms={rel:.5f} (bound "
                      f"0.05), max_abs={(got - want).abs().max().item():.5f}, "
                      f"max|ref|={want.abs().max().item():.4f}")
        if not (rel <= 0.05 and torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: bf16 decoder {name} disagrees with the fp32 plain decoder")
    gs = grid16.shape[1]
    wg = min(gs, math.ceil(pipe.options.metric_crop * scfg.image_size / size / 16) + 3)
    g = torch.Generator(device="cpu").manual_seed(gs)
    r0, c0 = (torch.randint(0, gs - wg + 1, (grid16.shape[0],), generator=g).cuda()
              for _ in range(2))
    if not torch.equal(window_crop(grid16, r0, c0, wg), window_crop_plain(grid16, r0, c0, wg)):
        raise AssertionError(f"{tag}: window_crop disagrees with its plain version")
    _say("slice", f"{tag} window_crop ({tuple(grid16.shape)} -> {wg} x {wg}) equals its plain "
                  f"version")


def _timed(tag: str, pipe, frames, card: str) -> float:
    """Median ms per batch of ``frames`` over TIMED_ITERS runs after a warm-up,
    with the stage means."""
    import torch

    pipe.process_batch_arrays(frames)  # warm-up at this shape
    per_iter = []
    stage_tot: dict = {}
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.process_batch_arrays(frames, stage_tot)
        per_iter.append(time.perf_counter() - t0)
    ms = statistics.median(per_iter) * 1000
    b = frames.shape[0]
    _say("slice", f"{tag} timed: batch {b}, {TIMED_ITERS} iterations, median {ms:.2f} ms/batch = "
                  f"{b / ms * 1000:.2f} img/s (iterations ms "
                  f"{[round(t * 1000, 2) for t in per_iter]}) [{card}]")
    _say("slice", f"{tag} stage ms/batch (mean): " + json.dumps(
        {key: round(v / TIMED_ITERS * 1000, 3) for key, v in stage_tot.items()}))
    return ms



def _large_frame_phase(card: str, vit_b_pipe, vit_h_pipe) -> dict:
    """Frames above 512 px: ViT-B on 768x768 frames (the 768 canvas, global
    window 48), then config 4, ViT-H bf16 on 2048x2048 frames (the 1024
    canvas, global window 64) from phase 6's ViT-H parameter tree."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    result: dict = {}
    rng = np.random.default_rng(5)
    frames = cell_frames(rng, SLICE_BATCH, MID_FRAME)
    expected = {**DECODER_COUNTS, "gemm_bf16": 48, "window_attn_relpos": 12}
    result["vit-b 768"], _, _ = _drive("ViT-B 768x768", vit_b_pipe, frames, 16, expected,
                                    by_window={16: 8, 48: 4})
    rels, _, _ = _embedding_vs_plain("ViT-B 768x768", {"bf16": (vit_b_pipe, 0.05)},
                                     frames[:1])
    result["rel_rms vit-b 768"] = rels["bf16"]
    result["ms vit-b 768"] = _timed("ViT-B 768x768", vit_b_pipe, frames, card)

    t0 = time.perf_counter()
    # random rel-pos tables, positional embedding, biases and LN affines from
    # here on: config 4's checks and the sequence-parallel phase (which runs
    # these trees) see the bias tables at each shard's rows
    _randomise_affines(vit_h_pipe.sam_params["vision"], np.random.default_rng(10))
    opts = tengine.PipelineOptions(max_det=16, metric_crop=128)
    pipe = _sharing_params(vit_h_pipe, opts)
    pipe._stages(LARGE_FRAME, LARGE_FRAME)
    _say("slice", f"config 4: ViT-H stages for {LARGE_FRAME}x{LARGE_FRAME} frames built (adapt "
                  f"to the 1024 canvas + cast + upload) {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    frames = cell_frames(rng, TIMED_BATCH, LARGE_FRAME, cells=BIG_CELLS)
    _say("slice", f"config 4: {TIMED_BATCH} frames made in {time.perf_counter() - t0:.2f} s")
    expected = {**DECODER_COUNTS, "gemm_bf16": 4 * 32, "window_attn_relpos": 32}
    result["config 4"], secs, out = _drive("config 4 (ViT-H, 2048x2048)", pipe,
                                           frames[:SLICE_BATCH], 16, expected,
                                           by_window={16: 28, 64: 4})
    # the 64 x 64 grid's stages: the encoder, then the decoder over 4096
    # tokens a prompt and the crop at gs 64
    rels, emb32, embs = _embedding_vs_plain("config 4 (ViT-H, 1024 canvas)",
                                            {"bf16": (pipe, 0.05)}, frames[:SP_BATCH])
    result["rel_rms config 4"] = rels["bf16"]
    # the sequence-parallel phase runs these frames on these weights
    result["sp inputs"] = (pipe, frames[:SP_BATCH], emb32.cpu(), embs["bf16"])
    _decoder_vs_plain("config 4", pipe, LARGE_FRAME, emb32[:1], out["boxes"][:1])
    # batch 32 when four more such batches fit in about a minute, else 8
    timed = frames if secs * 4 * (TIMED_ITERS + 1) <= 60 else frames[:SLICE_BATCH]
    _say("slice", f"config 4: timing batch {timed.shape[0]} (batch 8 took {secs:.2f} s)")
    result["ms config 4"] = _timed("config 4 (ViT-H, 2048x2048)", pipe, timed, card)
    result["batch config 4"] = timed.shape[0]
    pipe._stage_cache.clear()
    return result


def _mobile_slice_phase(card: str) -> dict:
    """MobileSAM (config 2): TinyViT-5M with SAM ViT-B's prompt encoder and
    decoder on 512x512 frames, bf16, max_det 16; then with conv2d_fused."""
    import dataclasses

    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    t0 = time.perf_counter()
    opts = tengine.PipelineOptions(max_det=16, metric_crop=128)
    pipe = tengine.CellSegmentationPipeline("mobile-sam", options=opts, device="cuda", seed=0)
    # the init's biases, LN shifts and attention bias tables are 0 (scales
    # 1): drawn at random here, so the pad-token qkv row, the bias tables and
    # the expanded halo's gelu(b1) reach the embedding check
    _randomise_affines(pipe.sam_params["tinyvit"], np.random.default_rng(7))
    pipe._stages(FRAME, FRAME)
    _say("slice", f"mobile-sam: pipeline built (init + cast + upload) "
                  f"{time.perf_counter() - t0:.2f} s")
    frames = cell_frames(np.random.default_rng(6), TIMED_BATCH, FRAME)
    # per batch: 10 window blocks (K13: one launch at stages 1 and 2, 8
    # blocks; at stage 3, 2 blocks, attention + 2 GEMMs; K16: depthwise + 2
    # GEMMs), MBConv x2 + merge2 (K14), merge0 + merge1 (K15); the neck's 2
    # LayerNorms, then the decoder's
    encoder = {"gemm_bf16": 24, "tinyvit_block": 8, "tinyvit_attn": 2, "mbconv_block": 3,
               "patch_merge_block": 2, "dw_conv3x3": 10, "layer_norm": 2}
    launches, _, _ = _drive("mobile-sam", pipe, frames[:SLICE_BATCH], 16,
                         {**DECODER_COUNTS, **encoder, "layer_norm": 10})
    rels, _, _ = _embedding_vs_plain("mobile-sam", {"bf16": (pipe, 0.05)}, frames[:1],
                                  encoder_expected=encoder)
    ms = _timed("mobile-sam", pipe, frames, card)
    # with conv2d_fused: YOLO's 39 dense convs, TinyViT's two stems and its neck's 3x3 on K17
    fpipe = _sharing_params(pipe, dataclasses.replace(opts, conv2d_fused=True))
    tag = "mobile-sam conv2d_fused"
    fused = {**encoder, "conv2d_act": 3}
    launches_f, _, _ = _drive(tag, fpipe, frames[:SLICE_BATCH], 16,
                              {**DECODER_COUNTS, **fused, "layer_norm": 10, "conv2d_act": 42})
    rels_f, _, _ = _embedding_vs_plain(tag, {"bf16": (fpipe, 0.05)}, frames[:1],
                                       encoder_expected=fused)
    ms_f = _timed(tag, fpipe, frames, card)
    # with tinyvit_mbconv_compute="bf16": K14 and K15 in their bf16 mode where
    # the JAX package's fused path would run them (the stage-0 MBConvs,
    # merge0 at 128 rows, merge2; merge1 at 64 rows keeps fp32)
    bpipe = _sharing_params(pipe, dataclasses.replace(opts, tinyvit_mbconv_compute="bf16"))
    tag = "mobile-sam mbconv bf16"
    bf16 = {**encoder, "mbconv_block_bf16": 3, "patch_merge_block_bf16": 1}
    launches_b, _, _ = _drive(tag, bpipe, frames[:SLICE_BATCH], 16,
                              {**DECODER_COUNTS, **bf16, "layer_norm": 10})
    rels_b, _, _ = _embedding_vs_plain(tag, {"bf16": (bpipe, 0.05)}, frames[:1],
                                       encoder_expected=bf16)
    turns = {"fp32": [ms], "bf16": []}
    for mode, p in (("bf16", bpipe), ("fp32", pipe), ("bf16", bpipe)):
        turns[mode].append(_timed(f"mobile-sam mbconv {mode} (in turns)", p, frames, card))
    _say("slice", f"mobile-sam: ms per batch of {TIMED_BATCH} in turns (fp32, then after the "
                  f"conv2d_fused pass bf16, fp32, bf16): fp32 "
                  f"{[round(v, 2) for v in turns['fp32']]}, bf16 "
                  f"{[round(v, 2) for v in turns['bf16']]} [{card}]")
    del pipe, fpipe, bpipe
    return {"launches": launches, "rel_rms": rels["bf16"], "ms_per_batch": ms,
            "launches conv2d_fused": launches_f, "rel_rms conv2d_fused": rels_f["bf16"],
            "ms conv2d_fused": ms_f, "launches bf16": launches_b, "rel_rms bf16": rels_b["bf16"],
            "turns bf16": turns}


def _randomise_affines(tree, rng) -> None:
    """Draw anew, in the tree, every bias and LN shift (0.1 N(0, 1)), LN scale
    (1 + 0.1 N(0, 1)) and attention bias table (0.5 N(0, 1)) of a TinyViT
    tree, and the rel-pos tables and positional embedding (0.1 N(0, 1)) of a
    SAM ViT tree: the init leaves them 0 (scales 1), which would hide the
    rel-pos bias, the pad-token keys and the row offsets of a shard."""
    for key, v in tree.items():
        if isinstance(v, dict):
            _randomise_affines(v, rng)
        elif isinstance(v, list):
            for item in v:
                _randomise_affines(item, rng)
        elif key == "scale":
            tree[key] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        elif key in ("b", "bias", "qkv_b", "proj_b", "mlp1_b", "mlp2_b"):
            tree[key] = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)
        elif key == "attn_bias":
            tree[key] = (0.5 * rng.normal(size=v.shape)).astype(v.dtype)
        elif key in ("rel_pos_h", "rel_pos_w", "pos_embed"):
            tree[key] = (0.1 * rng.normal(size=v.shape)).astype(v.dtype)


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
    ck = _conv_kernel_phase(card)
    fs = _fused_slice_phase(card, sp["pipe"], sp.pop("frames"), sp["ms_per_batch"])
    dr = _directory_phase(card, sp["pipe"])
    bk = _big_kernel_phase(card)
    big = {model.rsplit("-", 1)[-1]: _big_slice_phase(card, model, max_det, layers)
           for model, max_det, layers, *_ in BIG_MODELS}
    lk = _large_kernel_phase(card)
    vit_b_pipe = sp.pop("pipe")
    lf = _large_frame_phase(card, vit_b_pipe, big["huge"].pop("pipe"))
    rk = _relpos_kernel_phase(card)
    og = _offgrid_slice_phase(card, vit_b_pipe)
    sq = _sp_slice_phase(card, "config 4", *lf.pop("sp inputs"))
    sq896 = _sp_slice_phase(card, "896", *og.pop("sp inputs"))
    mk = _mobile_kernel_phase(card)
    ms = _mobile_slice_phase(card)

    def entry(name, route, source, replaces, launches, err, timed, bound, library=None,
              device=(None, None)):
        """One kernel's line: ``timed`` (kernel ms, plain ms, ...) and ``library``
        by events, ``bound`` (ms, "bytes" or "operations") at the same call,
        ``device`` (kernel, library call) by torch.profiler, None where not
        measured."""
        return {"name": name, "route": route,
                "source": f"yolo_sam_inference_tpu_torch/{source}",
                "replaces": f"yolo_sam_inference_tpu/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": timed[0], "plain_ms": timed[1], "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library, "device_ms": device[0],
                "library_device_ms": device[1]}

    t, kb = kp["times"], kp["bounds"]
    # the window attention: windows of 16 on window_attn_relpos.cu, the global
    # layers' windows (32, 48, 64) on flash_attention_relpos.cu's kernel
    attn_src, attn_tpu = "csrc/window_attn_relpos.cu", ("ops/flash_attention.py:608 "
                                                        "flash_attention_grid (+ :1085 "
                                                        "relpos_tables)")
    glob_src = "csrc/flash_attention_relpos.cu"
    table = [
        entry("gemm_bf16", "cuda", "csrc/gemm_bf16.cu",
              "ops/fused_ln.py:645 fused_ln_matmul (+ :202 fused_ln_mlp, projection of "
              "flash_attention.py:608)", sp["launches"]["gemm_bf16"], kp["errs"]["gemm_bf16"],
              t["gemm_bf16"], kb["gemm_bf16"]),
        entry("window_attn_relpos", "cuda", attn_src, attn_tpu,
              sp["launches"]["window_attn_relpos w16"], kp["errs"]["window_attn_relpos"],
              t["attn_w16"], kb["attn_w16"], kp["library"]["attn_w16"]),
        entry("window_attn_relpos w32", "cuda", glob_src, attn_tpu,
              sp["launches"]["window_attn_relpos w32"], kp["errs"]["window_attn_relpos"],
              t["attn_w32"], kb["attn_w32"], kp["library"]["attn_w32"]),
    ]
    # K5 at the neck's, the mask head's and the decoder's rows
    for key in ("layer_norm neck", "layer_norm up_ln", "layer_norm decoder"):
        table.append(entry(key, "cuda", "csrc/layer_norm.cu",
                           "ops/fused_ln.py:761 fused_ln (+ :56 fused_add_ln)",
                           sp["launches"]["layer_norm"], kp["errs"]["layer_norm"],
                           t[key], kb[key], kp["library"][key], kp["device"][key]))
    dt, db = dp["times"], dp["bounds"]
    for name, replaces, timed in (
        ("keys_stream", "ops/decoder_fused.py:298 i2t_keys_update (+ the k/v projections of "
                        ":231 t2i_shared_attend)", "keys_stream layer 1 pass alone"),
        ("t2i_combine", "ops/decoder_fused.py:298 i2t_keys_update (its next-stage t2i, joined "
                        "over the tiles)", "t2i_combine"),
        ("t2i_attend", "ops/decoder_fused.py:231 t2i_shared_attend", "t2i_attend"),
        ("window_crop", "ops/window_crop.py:46 window_crop", "window_crop"),
        ("hull_support", "ops/hull_support.py:55 support_vertices_tpu", "hull_support"),
    ):
        src = "decoder_keys.cu" if name.startswith(("keys", "t2i")) else f"{name}.cu"
        table.append(entry(name, "cuda", f"csrc/{src}", replaces, sp["launches"][name],
                           dp["errs"][name], dt[timed], db[timed], dp["library"].get(timed)))
    # at T = 784 (the 448 canvas's grid of 28: a short last tile)
    for name, replaces in (("keys_stream", "ops/decoder_fused.py:298 i2t_keys_update"),
                           ("t2i_combine", "ops/decoder_fused.py:298 i2t_keys_update (its "
                                           "next-stage t2i, joined over the tiles)")):
        table.append(entry(f"{name} T784", "cuda", "csrc/decoder_keys.cu", replaces,
                           og["launches 448"][name], dp["errs"][name], dt[f"{name} T784"],
                           db[f"{name} T784"]))
    # t2i_attend at the other grids: 28 (448 canvas), 14 (224), 64 (config 4)
    for tag, launches in (("T784", og["launches 448"]), ("T196", og["launches 224"]),
                          ("T4096", lf["config 4"])):
        table.append(entry(f"t2i_attend {tag}", "cuda", "csrc/decoder_keys.cu",
                           "ops/decoder_fused.py:231 t2i_shared_attend", launches["t2i_attend"],
                           dp["errs"]["t2i_attend"], dt[f"t2i_attend {tag}"],
                           db[f"t2i_attend {tag}"], dp["library"][f"t2i_attend {tag}"]))
    bt, bb = bk["times"], bk["bounds"]
    lb, hb = big["large"]["launches"], big["huge"]["launches"]
    table += [
        entry("gemm_bf16 K10", "cuda", "csrc/gemm_bf16.cu", "ops/fused_ln.py:302 "
              "fused_ln_mlp_tiled", lb["bf16"]["gemm_bf16"] + hb["bf16"]["gemm_bf16"],
              bk["errs"]["gemm_bf16"], bt["K10 ViT-H"], bb["K10 ViT-H"]),
        entry("window_attn_relpos hd80", "cuda", attn_src, attn_tpu,
              hb["bf16"]["window_attn_relpos w16"] + hb["int8"]["window_attn_relpos w16"],
              bk["errs"]["window_attn_relpos"], bt["attn hd80 w16"], bb["attn hd80 w16"],
              bk["library"]["attn hd80 w16"]),
        entry("window_attn_relpos hd80 w32", "cuda", glob_src, attn_tpu,
              hb["bf16"]["window_attn_relpos w32"] + hb["int8"]["window_attn_relpos w32"],
              bk["errs"]["window_attn_relpos"], bt["attn hd80 w32"], bb["attn hd80 w32"],
              bk["library"]["attn hd80 w32"]),
        entry("fused_ln_matmul_int8", "cuda", "csrc/gemm_int8.cu",
              "ops/fused_ln.py:711 fused_ln_matmul_int8",
              lb["int8"]["fused_ln_matmul_int8"] + hb["int8"]["fused_ln_matmul_int8"],
              bk["errs"]["fused_ln_matmul_int8"], bt["K11c ViT-H"], bb["K11c ViT-H"]),
        entry("fused_ln_mlp_int8", "cuda", "csrc/gemm_int8.cu",
              "ops/fused_ln.py:438 fused_ln_mlp_int8", lb["int8"]["fused_ln_mlp_int8"],
              bk["errs"]["fused_ln_mlp_int8"], bt["K11a ViT-L"], bb["K11a ViT-L"]),
        entry("fused_ln_mlp_tiled_int8", "cuda", "csrc/gemm_int8.cu",
              "ops/fused_ln.py:549 fused_ln_mlp_tiled_int8",
              hb["int8"]["fused_ln_mlp_tiled_int8"], bk["errs"]["fused_ln_mlp_tiled_int8"],
              bt["K11b ViT-H"], bb["K11b ViT-H"]),
        entry("window_attn_relpos w48", "cuda", glob_src, attn_tpu,
              lf["vit-b 768"]["window_attn_relpos w48"], lk["errs"]["window_attn_relpos"],
              lk["times"]["w48 hd64"], lk["bounds"]["w48 hd64"], lk["library"]["w48 hd64"]),
        entry("window_attn_relpos w64", "cuda", glob_src, attn_tpu,
              lf["config 4"]["window_attn_relpos w64"], lk["errs"]["window_attn_relpos"],
              lk["times"]["w64 hd80"], lk["bounds"]["w64 hd80"], lk["library"]["w64 hd80"]),
    ]
    mt, mb, ml, mla = mk["times"], mk["bounds"], mk["library"], ms["launches"]
    table += [
        # no one library call computes the whole window block
        entry("tinyvit_block", "cuda", "csrc/tinyvit_block.cu",
              "ops/tinyvit_attention.py:143 tinyvit_window_block (+ :384 "
              "tinyvit_window_block_cells)", mla["tinyvit_block"], mk["errs"]["tinyvit_block"],
              mt["K13 block stage2"], mb["K13 block stage2"], None,
              (mk["device"]["K13 block stage2"], None)),
        entry("tinyvit_attn", "cuda", "csrc/tinyvit_attn.cu",
              "ops/tinyvit_attention.py:143 tinyvit_window_block (+ :384 "
              "tinyvit_window_block_cells; its attention, at stage 3)", mla["tinyvit_attn"],
              mk["errs"]["tinyvit_attn"], mt["tinyvit_attn stage3 ws7"],
              mb["tinyvit_attn stage3 ws7"], ml["tinyvit_attn stage3 ws7"],
              (mk["device"]["tinyvit_attn stage3 ws7"], None)),
        entry("mbconv_block", "cuda", "csrc/mbconv.cu",
              "ops/mbconv_fused.py:134 mbconv_block", mla["mbconv_block"],
              mk["errs"]["mbconv"], mt["mbconv stage0"], mb["mbconv stage0"]),
        entry("patch_merge_block", "cuda", "csrc/mbconv.cu",
              "ops/merge_fused.py:125 patch_merge_block", mla["patch_merge_block"],
              mk["errs"]["patch_merge"], mt["patch_merge merge0"], mb["patch_merge merge0"],
              None, (mk["device"]["patch_merge merge0"], None)),
        entry("dw_conv3x3", "cuda", "csrc/tinyvit_conv.cu",
              "ops/dw_ln_mlp.py:88 dw_ln_mlp (its depthwise and LayerNorm in one pass; the "
              "MLP on gemm_bf16)", mla["dw_conv3x3"], mk["errs"]["dw_conv3x3"],
              mt["dw_conv3x3 stage3"], mb["dw_conv3x3 stage3"]),
        entry("dw_conv3x3 y only", "cuda", "csrc/tinyvit_conv.cu",
              "ops/dw_ln_mlp.py:88 dw_ln_mlp (its depthwise alone, as F.conv2d(groups=C))",
              mla["dw_conv3x3"], mk["errs"]["dw_conv3x3"], mt["dw_conv3x3 y only stage3"],
              mb["dw_conv3x3 y only stage3"], ml["dw_conv3x3 y only stage3"]),
        entry("mbconv_block bf16", "cuda", "csrc/mbconv.cu",
              "ops/mbconv_fused.py:134 mbconv_block (compute=\"bf16\")",
              ms["launches bf16"]["mbconv_block_bf16"], mk["errs"]["mbconv_bf16"],
              mt["mbconv stage0 bf16"], mb["mbconv stage0 bf16"]),
        entry("patch_merge_block bf16", "cuda", "csrc/mbconv.cu",
              "ops/merge_fused.py:125 patch_merge_block (compute=\"bf16\")",
              ms["launches bf16"]["patch_merge_block_bf16"], mk["errs"]["patch_merge_bf16"],
              mt["patch_merge merge0 bf16"], mb["patch_merge merge0 bf16"]),
    ]
    ct, cb, cl = ck["times"], ck["bounds"], ck["library"]
    for name, shape in (("conv2d_act", "detect box1 level 0"),
                        ("conv2d_act sam neck", "sam neck"),
                        ("conv2d_act yolo stem", "yolo stem")):
        table.append(entry(name, "cuda", "csrc/conv2d_act.cu",
                           "ops/conv2d_fused.py:428 conv2d_act (pallas_call :524)",
                           fs["launches"]["conv2d_act"], ck["errs"]["conv2d_act"], ct[shape],
                           cb[shape], cl[shape], (ck["device"][shape], None)))
    rt, rb, rl = rk["times"], rk["bounds"], rk["library"]
    k12_src = "csrc/flash_attention_relpos.cu"
    k12_tpu = "ops/flash_attention.py:186 flash_attention_relpos (pallas_call :266)"
    k12_err = rk["errs"]["flash_attention_relpos"]
    rd = rk["device"]
    table += [
        entry("flash_attention_relpos sp", "cuda", k12_src, k12_tpu, sq["k12"], k12_err,
              rt["sp ViT-H rank 1 of 2"], rb["sp ViT-H rank 1 of 2"],
              rl["sp ViT-H rank 1 of 2"], rd["sp ViT-H rank 1 of 2"]),
        entry("flash_attention_relpos global", "cuda", k12_src, k12_tpu,
              og["launches"]["flash_attention_relpos nq1600"], k12_err,
              rt["flat ViT-B global 40x40"], rb["flat ViT-B global 40x40"],
              rl["flat ViT-B global 40x40"], rd["flat ViT-B global 40x40"]),
        entry("flash_attention_relpos w14", "cuda", k12_src, k12_tpu,
              og["launches"]["flash_attention_relpos nq196"], k12_err,
              rt["flat ViT-B windows 14x14"], rb["flat ViT-B windows 14x14"],
              rl["flat ViT-B windows 14x14"], rd["flat ViT-B windows 14x14"]),
        entry("flash_attention_relpos sp w14", "cuda", k12_src, k12_tpu, sq896["k12_w14"],
              k12_err, rt["flat ViT-B windows 14x14"], rb["flat ViT-B windows 14x14"],
              rl["flat ViT-B windows 14x14"], rd["flat ViT-B windows 14x14"]),
        # no one library call returns both x + r and its LayerNorm
        entry("layer_norm residual", "cuda", "csrc/layer_norm.cu",
              "ops/fused_ln.py:56 fused_add_ln", og["launches"]["layer_norm_residual"],
              rk["errs"]["layer_norm"], rt["K11d"], rb["K11d"], None, (rd["K11d"][0], None)),
        entry("int8_linear", "cuda", "csrc/gemm_int8.cu",
              "ops/quant.py:66 int8_linear (XLA, the flat route's apply_linear: "
              "models/sam/model.py:223, :453-455; no pallas_call)",
              og["launches int8"]["int8_linear"], rk["errs"]["int8_linear"],
              rt["int8_linear qkv"], rb["int8_linear qkv"], rl["int8_linear qkv"]),
    ]
    _say("result", f"off-grid 640 {og['ms']:.2f} ms/batch of {TIMED_BATCH} = "
                   f"{TIMED_BATCH / og['ms'] * 1000:.2f} img/s, int8 {og['ms int8']:.2f} "
                   f"(medians of the turns); sp ({sq['backend']}, {SP_RANKS} ranks on one card) "
                   f"ms/batch of {SP_BATCH} by rank: config 4 {sq['ms']}, 896 {sq896['ms']} "
                   f"[{card}]")
    tb = ms["turns bf16"]
    bench = dr["bench"]
    _say("result", f"config 1 at batch {TIMED_BATCH}: fused_call {dr['fused_ips']:.2f} img/s, "
                   f"fused_call_chunked (bench) {bench['value']} img/s, synced p50 batch "
                   f"{bench['p50_batch_latency_ms']} ms; process_directory over {DIR_FILES} PNGs "
                   f"{dr['ips']:.2f} img/s (bench leg {bench['e2e_dir_ips']}), "
                   f"{dr['ips'] / dr['fused_ips']:.3f} of fused_call's; fetch ms whole "
                   f"{dr['fetch_ms']['whole']:.3f}, bitpacked {dr['fetch_ms']['packed']:.3f} "
                   f"[{card}]")
    _say("result", f"mobile-sam tinyvit_mbconv_compute bf16 "
                   f"{statistics.median(tb['bf16']):.2f} ms/batch of {TIMED_BATCH} (fp32 "
                   f"{statistics.median(tb['fp32']):.2f}; medians of the turns) [{card}]")
    _say("result", f"config 1 conv2d_fused {fs['ms_per_batch']:.2f} ms/batch of {TIMED_BATCH} "
                   f"(default {statistics.median(fs['turns']['default']):.2f}; medians of the "
                   f"turns); mobile-sam conv2d_fused "
                   f"{ms['ms conv2d_fused']:.2f} (default {ms['ms_per_batch']:.2f}) [{card}]")
    _say("result", f"mobile-sam {ms['ms_per_batch']:.2f} ms/batch of {TIMED_BATCH} = "
                   f"{TIMED_BATCH / ms['ms_per_batch'] * 1000:.2f} img/s; config 4 "
                   f"{lf['ms config 4']:.2f} ms/batch of {lf['batch config 4']} = "
                   f"{lf['batch config 4'] / lf['ms config 4'] * 1000:.2f} img/s [{card}]")
    for row in table:
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']}: no launch on its path")
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
