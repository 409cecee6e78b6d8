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
   to bf16 beforehand; the decoder kernels of layer 1 (``keys_stream``'s
   pass, ``t2i_combine``, ``t2i_attend`` with 16 prompts an image) at
   tq = tq2 in 7, 8, 9, 16, 17 and 34 prompt tokens (a box prompt's 7,
   point prompts' 5 + P + 1), each against its fp32 plain version (2%),
   timed beside it, with the bound and (``t2i_attend``) SDPA; K8
   (``window_crop``) at config 1's and config 4's crops on the engine's
   (N, 2) int64 starts and K9 (``hull_support``) from 512 ellipse masks of
   128 x 128, each equal to its plain version, with its device time;
3b. prompts: ViT-B at the 512 canvas (config 1's windows; seed 0, bf16, 8
   frames x 16 prompts) through ``SamModel``: point prompts (1, 3, 10
   points padded: tq 7, 9, 16), a box with 4 points (tq 11), 28 points (tq
   34), boxes with ``multimask_output`` through ``forward_boxes`` and boxes
   with a dense prompt, each call's launches counted from 0 (K6 1 + 1, K7
   2 + 2) and its sparse tokens, masks and IoU within 5% relative RMS of
   the same model in fp32 plain on the same bf16-rounded weights and the
   same bf16 inputs (the decoder on one bf16 embedding; ``forward_boxes``
   end to end);
4. slice: the config-1 pipeline (YOLOv8n + SAM ViT-B, 512x512 uint8 frames,
   bf16, random weights from seed 0): one batch of 8 with every kernel's
   launch count checked (every driven batch also checks that the plain hull
   front end, ``hull_candidates``, never ran), the bf16 image embedding of one frame against the
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
4d. checkpoint: state dicts drawn from a seed in the public namings
   (``bench/checkpoints.py``: HF ``SamModel`` ViT-B at its 1024 canvas,
   ultralytics YOLOv8n and v8s, ``mobile_sam.pt`` without its
   ``attention_bias_idxs``) written to a temporary directory; config 1 from
   the YOLOv8n and ViT-B files (the rel-pos tables 27 / 127 rows -> 31 / 63
   at the 512 canvas), its build timed in turns with the seeded build, a
   batch of 8 with the seeded pass's launch counts, the embedding and the
   decoder against fp32 plain; ``hull_mode="reference"`` on that batch, its
   16 metrics against the CPU plain path on the same crops (ints exact,
   floats 1e-5), the metrics stage timed in turns with the polygon's at
   batch 32; MobileSAM and YOLOv8s from their files (launch counts, the
   embedding, then ``conv2d_fused``: 42 K17 launches, output widths up to
   512, YOLO maps against fp32 plain); a missing path raises
   ``FileNotFoundError``; the runner on 8 PNG files from the same
   checkpoints with ``--hull-mode reference``;
4e. serve: the port's HTTP service (``web/serve.py``) in-process at config 1
   on the slice's stages, batch 32, loopback port 0: 96 requests (raw and
   PNG bodies, ``?masks=1``, ``?fmt=bin``) from 48 client threads, launch
   counts per batch dispatched, each response's cells against
   ``process_batch_arrays`` on the 32 frames as one batch (1e-5), its masks
   against the crops, each binary record against its JSON, ``/stats``;
   then ``bench/serve.py`` at batch 32, inflight 64, 256 measured requests,
   once with JSON and once with binary responses;
4f. project: ``apps/project_inference.main`` on 2 conditions x 2 ``batch_*``
   folders x 8 mode-L PNG frames, ``--roi 100,400 --batch-size 8``: launch
   counts, the file set, the combined and gated CSVs against the
   per-condition files and ``filter_cells_by_roi``, every row against
   ``process_batch_arrays`` on the same frames (1e-5);
4g. apps: ``apps/quant_report.run_report`` over 32 frames with a bf16 and a
   ``quant="int8"`` config-1 pipeline on the same weights (K11a and K11c
   counted; the summary against ``compare_outputs`` of their own outputs;
   finite values) and ``apps/yolo_frame_cleaner.clean_frames`` with
   ``conv2d_fused=True`` (39 K17 launches; each frame's class against
   ``classify_frame`` on ``detect_batch_arrays``; its files); then the project
   runner with ``--interactive-roi``, its browser picker driven by an HTTP
   client (the page, each condition's image, the ROIs posted; launch
   counts), its rows against ``--roi-file`` with the same ROIs;
4h. classical: ``ops/morphology.py`` on (16, 512, 512) frames against the
   CPU port (masks equal, blur and contrast within 1e-5); the classical
   project runner over 2 conditions x 64 generated 512x512 PNGs with
   ``--thresholds 10,20 --batch-size 16`` on the card (K9 once a batch with
   a component, no other kernel) and on the CPU, its CSVs against each
   other (ints exact, floats 1e-5); with visualizations on 4 frames; the
   stream runner over an ``images.bin`` of 2048 256x256 frames on the card
   and the CPU (its CSV byte-equal); K9 at a batch's cells; frames/s of both
   runners and the split of a batch (upload, device morphology, fetch,
   host label + crop, metrics call; decode and cv2 topology of the stream);
4i. registry: a ``WorkManifest`` over 32 mode-L 512x512 PNG frames and one
   unreadable file (its name holds ``<script>``); ``process_pending`` on the
   config-1 stages (one ``process_batch_arrays`` a file: K1-K9 once a file,
   counted), files/s, each stored row against ``process_batch_arrays`` of
   its frame alone (boxes, confidences, the 9 stored metrics within 1e-5,
   the decoded full-frame mask exact), a second pass processing nothing,
   the error row; ``manifest_cli`` and ``batch_readout`` once;
   ``build_report``; ``serve_viewer`` on loopback (pages answer 200, the
   ``<script>`` path escaped);
4j. dp: 2 ranks (``parallel/launch.py``, gloo, both on the one card), each
   with config 1 under ``mesh=make_mesh(dp=2)``: 32 and 30 frames (the
   padding) through ``process_batch_arrays``, each rank's launch counts on
   its 16 frames, its outputs equal on both ranks and to the single card on
   the same frames, in the ranks' batches and in one batch; ``process_directory`` under the
   mesh over 64 PNG files (rows against the single card at batch 16, one
   run id, rank 0 alone writes); ``run_sharded_directory`` +
   ``merge_csv_shards`` (rank 0's merged CSV against the single card's rows
   of each shard's batch); the flat-folder runner with ``--encoder-parallel
   sp --parallel-devices 2`` to rc 0, its rows against the single-card
   runner's (the same cells, each metric within 2% relative RMS); wall times
   labelled as two ranks on one card (no dp speed-up measurable);
4k. frames: K9 on masks with a side above 256 (its frames' kernels), exact
   against its plain version on 2049^2 and 8192^2 masks, timed at 2048^2,
   4096^2 and 8192^2 beside its bound; ``calculate_metrics`` on a 2100 x
   2300 frame on the card in both hull modes (K9 once a call, counted),
   against its CPU run and the float64 oracle of the brightness disk;
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
14. tp: ``gemm_bf16`` at the row-parallel products' K (384, 640) against
   its fp32 plain version, beside ``torch.mm``; the tensor-parallel encoder
   (``parallel/tp.py``) on 2 gloo ranks sharing the card, ViT-B (config 1's
   weights) and ViT-H (8 heads a rank, hd 80) at the 512 canvas, each rank
   holding only its shard: launch counts per rank, the embedding equal
   across ranks and against the single card's bf16 and fp32 plain encoders
   (2% / 5%), ms by rank; config 1 with ``encoder_parallel="tp"`` on the
   pair, and on (dp 2, sp 2) and (dp 2, tp 2) meshes of 4 ranks: launch
   counts, outputs against the single card's (boxes and detections exact,
   masks on 99% of pixels, metrics 2%);
15. train: ``parallel/train.py`` at ViT-B's full width on the 512 canvas,
   8 frames x 16 boxes, 128² random targets, 3 AdamW steps: step 1's
   gradients through the kernels (``ops/autograd.py``) against fp32 plain
   autograd on the card, cosine per tensor (0.99), every leaf the loss
   reaches with a non-zero gradient, the forward's launch counts those of
   inference, the loss falling, each step's forward / backward / update ms;
   then 2 steps on a dp 2 x tp 2 mesh of 4 ranks against the single card
   (losses 1%, the replicated parameters bit-equal on all ranks);
16. pp: ViT-B in 2 stages (``parallel/pp.py``), 4 microbatches of 2 frames:
   launch counts per stage, the embedding against the single card's;
17. multichip: ``parallel.dryrun.dryrun_multichip(4)`` (the dp engine, the
   tp, sp and pp encoders, the dp x tp and dp x sp engines, two dp x tp
   train steps, at ViT-B's widths cut to 2 layers);
17b. Hiera: SAM 2.1 Hiera-L's attention (``csrc/hiera_attention.cu``) at
   each case of ``Sam2Config.attention()`` at the benchmark cell's batch 8
   (1024 canvas, hd 72; the pooling block's qkv a column slice of rows 4C
   apart) against its fp32 plain version (2%), timed by events and on the
   device beside the plain version, the bound (``cytobench/flops.py``'s
   peaks) and, as the library yardstick the port never calls, the windows
   gathered by strided copies, ``scaled_dot_product_attention`` and the copy
   back into token order; then one batch of 8 2048 x 2048 frames through
   the ``facebook/sam2.1-hiera-large`` pipeline (``_drive``: every launch
   count, the attention's by case, one a block);
17c. resample: ``csrc/resample.cu`` at the 2048² cells' two resizes (8
   gray frames to the letterbox's 640 and SAM's 1024 canvas, the engine's
   stride-0 channel view) against its plain version (the dense fp32 einsum
   on the card) on the 0-255 scale, timed with the L2 flushed before each
   call (a 256 MB read: the frames would sit in it) by events and on the
   device, beside its bytes bound (the uint8 frames read once, the fp32
   canvas written once), the plain version and the benchmark's fp32
   reference (``cytobench/reference/preprocess.py``); every drive expects
   one launch for each stage whose resized area differs from the frame;
18. result: the kernel table as one JSON line (each kernel's launches on its
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
SERVE_REQUESTS = 3 * TIMED_BATCH  # the service's requests: three a frame
SERVE_CLIENTS = 48  # client threads posting them
SERVE_BENCH_ARGS = ("--inflight", "64", "--requests", "256", "--warm-requests", "64")
PROJECT_FILES = 8  # PNG files a batch_* folder of the project runner's tree
CLASSICAL_FRAMES = 64  # PNG frames a condition of the classical project (2 conditions)
CLASSICAL_SIZE = 512
STREAM_FRAMES = 2048  # frames of the classical phase's images.bin stream
STREAM_SIZE = 256
REGISTRY_FILES = 32  # PNG files of the [registry] phase's manifest (one unreadable more)
DP_RANKS = 2  # data-parallel ranks (one card: they share it)
DP_FILES = 64  # PNG files through process_directory under the mesh and the sharded run
TP_RANKS = 2  # tensor-parallel ranks of [tp] (one card: they share it)
MESH_RANKS = 4  # ranks of the dp x sp / dp x tp meshes, [train]'s dp x tp and [multichip]
TRAIN_BOXES = 16  # box prompts a frame in [train]
TRAIN_STEPS = 3
# Adam's first steps move each of ViT-B's ~93M weights by about the learning
# rate; at optax's default 1e-4 (and 1e-5) the loss on random targets rises at
# step 2, so [train] steps at 1e-6 and shows one default-rate run beside it
TRAIN_LR = 1e-6
# [train]'s gates on step 1's gradients, tensor by tensor, against a reference
# (fp32 plain autograd; on dp 2 x tp 2 the single card's): the cosine, and the
# norm ratio |g| / |g_ref|, which the cosine cannot see and AdamW's step hardly
# depends on (a gradient summed where it should be averaged is off by tp)
GRAD_COS_MIN, GRAD_NORM_TOL = 0.99, 0.05
PP_RANKS, PP_MICROBATCHES = 2, 4
# published H100 SXM peaks (NVIDIA data sheet): bytes/s and operations/s
PEAK = {"hbm": 3.35e12, "bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# the decoder, crop and hull kernels of one batch (max_det prompts an image)
DECODER_COUNTS = {"layer_norm": 10, "keys_stream": 3, "t2i_attend": 1, "t2i_combine": 2,
                  "window_crop": 1, "hull_support": 1}
# MobileSAM's encoder a batch: 10 window blocks (K13: one launch at stages 1
# and 2, 8 blocks; at stage 3, 2 blocks, attention + 2 GEMMs; K16: depthwise
# + 2 GEMMs), MBConv x2 + merge2 (K14), merge0 + merge1 (K15); the neck's 2
# LayerNorms
MOBILE_ENCODER_COUNTS = {"gemm_bf16": 24, "tinyvit_block": 8, "tinyvit_attn": 2,
                         "mbconv_block": 3, "patch_merge_block": 2, "dw_conv3x3": 10,
                         "layer_norm": 2}
CONFIG1_COUNTS = {**DECODER_COUNTS, "gemm_bf16": 48, "window_attn_relpos": 12}
# SAM 2.1 Hiera-L a batch (its attention counted apart): 4 GEMMs a block over
# 48 blocks, the neck's 4 laterals, conv_s1 and conv_s0; the decoder's
# LayerNorms (no neck LayerNorm), its kernels, the crop and the hull; the
# 2048² frames' resample to the letterbox's 640 and SAM's 1024 canvas
SAM2_COUNTS = {"gemm_bf16": 4 * 48 + 4 + 2, "layer_norm": 8, "keys_stream": 3, "t2i_attend": 1,
               "t2i_combine": 2, "window_crop": 1, "hull_support": 1, "resample": 2}


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


def _hull_bound(masks, d: int) -> tuple:
    """K9's bound: the bool crops read once, the (N, D, 2) fp32 points and
    the (N,) flags written once; a score (2 mul, 1 add) for each candidate
    these masks have, two for each row and each column with a pixel, and
    each direction. The compares are no flops at the fp32 peak."""
    n, h, w = masks.shape
    live = 2 * (int(masks.any(2).sum()) + int(masks.any(1).sum()))
    return _bound(3.0 * live * d, n * h * w + n * d * 2 * 4 + n, "fp32")



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


PROMPT_TQS = (7, 8, 9, 16, 17, 34)  # a box prompt's 7 prompt tokens; point prompts' 5 + P + 1


def _crop_and_hull_kernels(n: int, c: int, g, errs: dict, times: dict, bounds: dict,
                           device: dict) -> None:
    """K8 and K9 at the config-1 batch-32 shapes (n prompts, c channels),
    each exact against its plain version, timed by events and on the device,
    with its bound; K8 also at config 4's crop."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import (after_l2_flush, device_ms,
                                                           ellipse_masks, median_ms)
    from yolo_sam_inference_tpu_torch.ops.hull_support import hull_support, hull_support_plain
    from yolo_sam_inference_tpu_torch.ops.metrics import _hull_directions
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop, window_crop_plain

    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(dev, torch.bfloat16)

    # window_crop: a copy, exact; the starts as the engine passes them (the
    # two columns of one (N, 2) int64 tensor, read in place), at config 1's
    # 11 x 11 windows of the 32 x 32 grid and config 4's 7 x 7 of 64 x 64
    for key, gs, wg in (("window_crop", 32, 11), ("window_crop gs64", 64, 7)):
        grid = randn(n, gs, gs, c)
        starts = torch.randint(0, gs - wg + 1, (n, 2), generator=g).to(dev)
        fn = lambda: window_crop(grid, starts[:, 0], starts[:, 1], wg)
        ref = lambda: window_crop_plain(grid, starts[:, 0], starts[:, 1], wg)
        got, want = fn(), ref()
        _check(f"{key} ({n}x{gs}x{gs}x{c} -> {wg}x{wg})", got, want, 0.0, errs)
        if not torch.equal(got, want):
            raise AssertionError(f"{key}: the kernel's copy differs from its plain version")
        times[key] = (median_ms(fn), median_ms(ref))
        # on the device with the L2 flushed before each call: in the
        # pipeline K7 has just written the 268 MB grid; back-to-back calls
        # would find the windows in L2. Also after a 256 MB write, which
        # leaves the L2 full of dirty lines, as K7 does
        device[key] = (device_ms(after_l2_flush(fn), "window_crop"), None)
        bounds[key] = _bound(0.0, 2 * n * wg * wg * c * 2 + _nbytes(starts))  # the crops only
        dirty = torch.empty(64 << 20, device=dev)
        after_write = lambda: (dirty.fill_(1.0), fn())
        _say("kernels", f"{key}: device {_fmt(device[key][0])} after a 256 MB read, "
                        f"{_fmt(device_ms(after_write, 'window_crop'))} after a 256 MB write, "
                        f"{_fmt(device_ms(fn, 'window_crop'))} warm (L2 kept between calls)")
        del grid, dirty
    # hull_support: elliptical 128 x 128 masks to support points, exact
    masks = torch.from_numpy(ellipse_masks(np.random.default_rng(1), n, 128)).to(dev)
    dirs = torch.from_numpy(_hull_directions(256)).to(dev)
    fn, ref = lambda: hull_support(masks, dirs), lambda: hull_support_plain(masks, dirs)
    for part, got, want in zip(("points", "non-empty"), fn(), ref()):
        _check(f"hull_support ({n} cells of 128 x 128 x 256 directions): {part}", got, want, 0.0,
               errs)
        if not torch.equal(got, want):
            raise AssertionError(f"hull_support: the kernel's {part} differ from the plain version")
    times["hull_support"] = (median_ms(fn), median_ms(ref))
    device["hull_support"] = (device_ms(fn, "hull_support"), None)
    bounds["hull_support"] = _hull_bound(masks, 256)


def _decoder_kernel_phase(card: str) -> dict:
    """The decoder, crop and hull kernels at the config-1 batch-32 shapes:
    B*K = 512 prompt streams of 1024 tokens x 256 channels, 7 prompt tokens
    (layer 1 also at each of PROMPT_TQS), 8 heads of 16; an 11 x 11 crop of
    the 32 x 32 grid; 512 candidates x 256 directions per cell."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec

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
    device: dict = {}

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
        "k/v projection (32 images)": (
            lambda: dec.kv_project(img, pe, *kv, 8),
            lambda: dec.kv_project_plain(img.float(), pe.float(), *kv), ("kp", "vp")),
    }
    for label, (fn, ref, parts) in runs.items():
        for got, want, part in zip(fn(), ref(), parts):
            _check(f"keys_stream {label}: {part}", got, want, 2e-2, errs)
        times[f"keys_stream {label}"] = (median_ms(fn), median_ms(ref, reps=3, warmup=1))
    # K6's projection pass: k and v (2 C dh each a token)
    bounds["keys_stream k/v projection (32 images)"] = _bound(
        4.0 * b * t * c * dh, _nbytes(img, pe, w["wk"], w["wv"], bk, bv) + 2 * b * t * dh * 2)
    qp = randn(n, tq, dh, std=0.25)  # t2i_attend's queries at T 4096
    kp_, vp_ = randn(b, t, dh), randn(b, t, dh)

    # one library call on the same inputs: an image's 16 prompts share its
    # keys, so their 16 x tq (pre-scaled) queries attend as one sequence
    def sdpa_of(q, kv_k, kv_v):
        tt = kv_k.shape[1]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q.reshape(b, -1, 8, 16).transpose(1, 2),
            kv_k.reshape(b, tt, 8, 16).transpose(1, 2), kv_v.reshape(b, tt, 8, 16).transpose(1, 2),
            scale=1.0)

    def layer1(keys_t, pe_t, tq, tag):
        """Layer 1 at tq = tq2 prompt tokens over keys_t (512 streams): the
        i2t_keys_update call (keys_stream's pass, then t2i_combine) and
        t2i_attend of 16 prompts over an image's k/v (K6), each against its
        fp32 plain version, timed, with its bound."""
        kq_, vq_, qn_ = randn(n, tq, dh), randn(n, tq, dh), randn(n, tq, dh, std=0.25)
        tt = keys_t.shape[1]
        fn = lambda: dec.i2t_keys_update(keys_t, pe_t, kq_, vq_, *w_i2t, heads=8,
                                         t2i={"qp": qn_, **nxt})
        ref = lambda: dec.i2t_keys_update_plain(
            keys_t.float(), pe_t.float(), kq_.float(), vq_.float(), *w_i2t, heads=8,
            t2i={"qp": qn_.float(), **nxt})
        for got, want, part_name in zip(fn(), ref(), ("keys", "attn")):
            _check(f"keys_stream i2t layer 1 {tag} (512 streams): {part_name}", got, want, 2e-2,
                   errs)
        pass1 = lambda: dec.keys_stream(keys_t, pe_t, *kv, qn=qn_, i2t=(kq_, vq_, *w_i2t))
        keys1, part = pass1()  # the new keys and the next attention's partials
        # the partials the pass writes and the combine reads: those of the tq
        # next queries (the slots of the last group past tq stay unwritten)
        part_bytes = _nbytes(part) // dec.part_slots(tq) * tq
        times[f"keys_stream {tag}"] = (median_ms(pass1), median_ms(ref, reps=3, warmup=1))
        # per token: q, out, k and v projections (8 C dh), i2t over tq and the
        # next attention's partials over tq (4 dh each a query)
        bounds[f"keys_stream {tag}"] = _bound(
            n * tt * (8.0 * c * dh + 4.0 * 2 * tq * dh),
            _nbytes(keys_t, pe_t, kq_, vq_, qn_, bq, bk, bv, bo, ln_s, ln_b, *w.values(), keys1)
            + part_bytes)
        fn, ref = lambda: dec.t2i_combine(part, tq), lambda: dec.t2i_combine_plain(part, tq)
        _check(f"t2i_combine {tag} (512 streams x {part.shape[1]} tiles)", fn(), ref(), 2e-2,
               errs)
        times[f"t2i_combine {tag}"] = (median_ms(fn), median_ms(ref))
        bounds[f"t2i_combine {tag}"] = _bound(0.0, part_bytes + n * tq * dh * 2)
        del keys1, part
        kp_t, vp_t = (kp_, vp_) if tt == t else (randn(b, tt, dh), randn(b, tt, dh))
        fn = lambda: dec.t2i_attend(qn_, kp_t, vp_t, 8, k)
        ref = lambda: dec.t2i_attend_plain(qn_.float(), kp_t.float(), vp_t.float(), 8, k)
        _check(f"t2i_attend {tag} shared (k_share 16: {k * tq} rows an image)", fn(), ref(), 2e-2,
               errs)
        times[f"t2i_attend {tag}"] = (median_ms(fn), median_ms(ref, reps=5))
        bounds[f"t2i_attend {tag}"] = _bound(4.0 * n * tq * tt * dh,
                                             _nbytes(qn_, kp_t, vp_t) + _nbytes(qn_))
        library[f"t2i_attend {tag}"] = median_ms(sdpa_of(qn_, kp_t, vp_t))

    # T 1024 at every prompt-token count: a box prompt's 7, point prompts'
    # 5 + P + 1 (above 8 the kernels take their grouped form)
    for tq_ in PROMPT_TQS:
        layer1(keys, pe, tq_, f"tq{tq_}")
    _crop_and_hull_kernels(n, c, g, errs, times, bounds, device)
    del keys
    torch.cuda.empty_cache()

    # the grids of the 224 and 448 canvases: T = 196 and 784 tokens, whose
    # last 128-token tile is short; each kernel against its fp32 plain version
    for gs in (14, 28):
        tt, tag = gs * gs, f"T{gs * gs}"
        pe_t, img_t, keys_t = randn(tt, c), randn(b, tt, c), randn(n, tt, c)
        for got, want, part_name in zip(dec.kv_project(img_t, pe_t, *kv, 8),
                                        dec.kv_project_plain(img_t.float(), pe_t.float(), *kv),
                                        ("kp", "vp")):
            _check(f"keys_stream k/v projection {tag} (32 images): {part_name}", got, want, 2e-2,
                   errs)
        layer1(keys_t, pe_t, tq, tag)
        del pe_t, img_t, keys_t
        torch.cuda.empty_cache()
    # T 4096: the 64 x 64 grid of config 4's 1024 canvas
    kp_t, vp_t = randn(b, 4096, dh), randn(b, 4096, dh)
    fn = lambda: dec.t2i_attend(qp, kp_t, vp_t, 8, k)
    ref = lambda: dec.t2i_attend_plain(qp.float(), kp_t.float(), vp_t.float(), 8, k)
    _check("t2i_attend T4096 shared (k_share 16)", fn(), ref(), 2e-2, errs)
    times["t2i_attend T4096"] = (median_ms(fn), median_ms(ref, reps=5))
    bounds["t2i_attend T4096"] = _bound(4.0 * n * tq * 4096 * dh, _nbytes(qp, kp_t, vp_t, qp))
    library["t2i_attend T4096"] = median_ms(sdpa_of(qp, kp_t, vp_t))
    del kp_t, vp_t
    for name, (ms, plain) in times.items():
        extra = f", bound {bounds[name][0]:.4f} ms ({bounds[name][1]})" if name in bounds else ""
        if name in library:
            extra += f", library {library[name]:.4f} ms"
        if name in device:
            extra += f", device {_fmt(device[name][0])}"
        _say("kernels", f"{name}: kernel {ms:.4f} ms, plain {plain:.4f} ms{extra} [{card}]")
    torch.cuda.synchronize()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library, "device": device}


PROMPT_DECODER_COUNTS = {"layer_norm": 8, "keys_stream": 3, "t2i_attend": 1, "t2i_combine": 2}


def _prompts_phase(card: str) -> dict:
    """[prompts]: SAM's prompt API at ViT-B's full width through ``SamModel``
    on the card (the kernels alone at every prompt-token count are in
    ``_decoder_kernel_phase``)."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.models.sam import init_sam_params
    from yolo_sam_inference_tpu_torch.pipeline.engine import _round_floating
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    bf = torch.bfloat16
    # ViT-B at config 1's encoder, 8 frames x 16 prompts
    cfg = _vit_512("vit-b")
    tree = init_sam_params(0, cfg)
    _, sam = from_jax_params(None, tree, "cuda", bf, sam_config=cfg)
    _, ref_model = from_jax_params(None, _round_floating(tree, bf), "cuda", torch.float32,
                                   sam_config=cfg)
    del tree
    rng = np.random.default_rng(19)
    fb, fk, gs = SLICE_BATCH, 16, cfg.grid_size

    def host(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).cuda()

    def box_prompts():
        xy = rng.uniform(0, 0.75 * FRAME, size=(fb, fk, 2))
        return host(np.concatenate([xy, xy + rng.uniform(0.03, 0.25, size=(fb, fk, 2)) * FRAME],
                                   -1))

    def point_prompts(p):
        pts = host(rng.uniform(0, FRAME, size=(fb, fk, p, 2)))
        labels = rng.integers(0, 2, size=(fb, fk, p))
        labels[..., 0] = 1  # a foreground point in every prompt
        return pts, torch.from_numpy(labels.astype(np.int32)).cuda()

    # one bf16 input for both sides: the pixels, and the embedding the
    # decoder calls share (the fp32 plain encoder's, rounded once)
    pix16 = host(rng.normal(size=(fb, FRAME, FRAME, 3))).to(bf)
    with torch.inference_mode():
        emb16 = ref_model.vision(pix16.float(), plain=True).to(bf)

    def rel_rms(x, y):
        return ((x.float() - y.float()).norm() / y.float().norm()).item()

    def gate(tag, got, want, tq, names=("masks", "iou")):
        rels = []
        for part_name, x, y in zip(names, got, want):
            if tuple(x.shape) != tuple(y.shape) or not torch.isfinite(x.float()).all():
                raise AssertionError(f"[prompts] {tag}: {part_name} {tuple(x.shape)} against "
                                     f"{tuple(y.shape)}, or not finite")
            rels.append(rel_rms(x, y))
        _say("prompts", f"{tag} (tq {tq}, {fb} frames x {fk} prompts, {names[0]} "
                        f"{tuple(got[0].shape)}): rel_rms "
                        + ", ".join(f"{nm} {r:.5f}" for nm, r in zip(names, rels))
                        + f" (bound 0.05) against fp32 plain [{card}]")
        if max(rels) > 0.05:
            raise AssertionError(f"[prompts] {tag}: bf16 kernels disagree with fp32 plain")
        return rels

    def decode(tag, sparse16, sparse32, tq, dense=None, multimask=False):
        """The prompt encoder's bf16 tokens against its fp32 ones, then the
        decoder on those bf16 tokens against fp32 plain on the same values,
        counts from 0."""
        if sparse16.shape[2] + cfg.num_mask_tokens + 1 != tq:
            raise AssertionError(f"[prompts] {tag}: {sparse16.shape[2]} sparse tokens, not tq {tq}")
        gate(f"{tag}: prompt encoder", (sparse16,), (sparse32,), tq, ("sparse",))
        d16 = None if dense is None else dense.to(bf)
        with torch.inference_mode():
            wrappers = _reset_counts()
            got = sam.mask_decoder(emb16, sparse16, d16, multimask_output=multimask)
            torch.cuda.synchronize()
            _read_counts(f"[prompts] {tag}", wrappers, PROMPT_DECODER_COUNTS)
            want = ref_model.mask_decoder(emb16.float(), sparse16.float(),
                                          None if d16 is None else d16.float(),
                                          multimask_output=multimask, plain=True)
        return gate(tag, got, want, tq)

    rels = {}
    for p in (1, 3, 10, 28):
        pts, labels = point_prompts(p)
        with torch.inference_mode():
            s16, s32 = sam.prompt.points(pts, labels).to(bf), ref_model.prompt.points(pts, labels)
        tag = f"{p} point{'s' if p > 1 else ''}"
        rels[tag] = decode(tag, s16, s32, p + 6)
    boxes = box_prompts()
    pts, labels = point_prompts(4)
    with torch.inference_mode():
        s16 = torch.cat([sam.prompt.boxes(boxes), sam.prompt.points(pts, labels, pad=False)], 2)
        s32 = torch.cat([ref_model.prompt.boxes(boxes),
                         ref_model.prompt.points(pts, labels, pad=False)], 2)
    rels["box + 4 points"] = decode("box + 4 points", s16.to(bf), s32, 11)
    boxes = box_prompts()
    dense = host(0.1 * rng.normal(size=(fb, gs, gs, cfg.prompt_hidden)))
    with torch.inference_mode():
        s16, s32 = sam.prompt.boxes(boxes).to(bf), ref_model.prompt.boxes(boxes)
    rels["boxes + dense"] = decode("boxes + dense prompt", s16, s32, 7, dense=dense)
    # multimask through the entry point, encoder included
    boxes = box_prompts()
    with torch.inference_mode():
        wrappers = _reset_counts()
        got = sam.forward_boxes(pix16, boxes, multimask_output=True)
        torch.cuda.synchronize()
        _read_counts("[prompts] forward_boxes multimask", wrappers, TRAIN_COUNTS)
        want = ref_model.forward_boxes(pix16.float(), boxes, multimask_output=True, plain=True)
    if got[0].shape[2] != cfg.num_mask_tokens - 1:
        raise AssertionError(f"[prompts] multimask: {got[0].shape[2]} masks a prompt")
    rels["forward_boxes multimask"] = gate("forward_boxes multimask (end to end)", got, want, 7)
    del sam, ref_model, emb16, pix16, got, want
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_start
    _say("prompts", f"phase {secs:.1f} s [{card}]")
    return {"rels": rels, "secs": secs}


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
    pipe = tengine.CellSegmentationPipeline(sam_model_type=spec["model"], options=opts,
                                            device="cuda", params=(trees["yolo"], trees["sam"]))
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


def _hiera_case(grid: int, window: int, pool: bool) -> str:
    """A name for one case of ``hiera_window_attention.by_window``."""
    return f"g{grid} {f'w{window}' if window else 'global'}{' pooled' if pool else ''}"


def _hiera_cases() -> dict:
    """Hiera-L's attention cases at the 1024 canvas, from its
    ``attention()``: name -> (grid, heads, window, pool)."""
    from yolo_sam_inference_tpu_torch.models.sam import sam2_1_hiera_l

    return {_hiera_case(grid, window, pool): (grid, heads, window, pool)
            for grid, heads, window, pool in sam2_1_hiera_l().attention()}


def _hiera_library(qkv, heads: int, window: int, pool: bool):
    """The yardstick of ``hiera_window_attention``: q, k and v of each
    window gathered by strided copies (q max-pooled), SDPA, the output
    copied back into token order. The port never calls it."""
    import torch.nn.functional as F

    b, s, _, c3 = qkv.shape
    c = c3 // 3
    hd, w = c // heads, window or s
    n = s // w
    wq = w // 2 if pool else w
    t = qkv.reshape(b, n, w, n, w, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    k, v = (t[i].reshape(b * n * n, heads, w * w, hd) for i in (1, 2))
    q = t[0]
    if pool:
        q = q.reshape(b, n, n, heads, wq, 2, wq, 2, hd).amax(dim=(-4, -2))
    o = F.scaled_dot_product_attention(q.reshape(b * n * n, heads, wq * wq, hd), k, v)
    o = o.reshape(b, n, n, heads, wq, wq, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, n * wq, n * wq, c)


def _hiera_attention_phase(card: str) -> dict:
    """Phase 17b: ``hiera_window_attention`` at Hiera-L's cases at batch 8
    against its plain version, timed (events, device) beside the plain
    version, the bound and the library yardstick; then one batch of 8
    2048 x 2048 frames through the SAM 2.1 Hiera-L pipeline, whose launch
    counts by case are the kernel table's."""
    import collections

    import numpy as np
    import torch

    from cytobench.flops import PEAK as FLOPS_PEAK, least_s
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, device_ms, median_ms
    from yolo_sam_inference_tpu_torch.models.sam import sam2_1_hiera_l
    from yolo_sam_inference_tpu_torch.ops.hiera_attention import (
        hiera_window_attention,
        hiera_window_attention_plain,
    )
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    t0 = time.perf_counter()
    b, hd = SLICE_BATCH, 72
    g = torch.Generator().manual_seed(28)
    errs, times, bounds, library, device = {}, {}, {}, {}, {}
    for case, (s, heads, window, pool) in _hiera_cases().items():
        c = heads * hd
        wide = 4 if pool else 3  # a pooling block's qkv: 3C columns of its [qkv | shortcut]
        y = (torch.randn(b * s * s, wide * c, generator=g) * 2).to("cuda", torch.bfloat16)
        qkv = y[:, :3 * c].reshape(b, s, s, 3 * c)
        fn = lambda: hiera_window_attention(qkv, heads, window, pool)
        fnp = lambda: hiera_window_attention_plain(qkv, heads, window, pool)
        fnl = lambda: _hiera_library(qkv, heads, window, pool)
        _check(f"hiera_attention {case} ({b}x{s}x{s}x{3 * c}, {heads} heads, window "
               f"{window or s}, pool {pool})", fn(), fnp(), 2e-2, errs)
        w = window or s
        nk, nq = w * w, (w * w // 4 if pool else w * w)
        flops = b * (s // w) ** 2 * heads * 4.0 * nq * nk * hd
        so = s // 2 if pool else s
        nbytes = 2 * (b * s * s * 3 * c + b * so * so * c)  # q, k, v read once, the output written
        least_ms = least_s(flops, nbytes) * 1e3
        by_ops = flops / FLOPS_PEAK["bf16"] * 1e3 >= least_ms
        bounds[case] = (least_ms, "operations" if by_ops else "bytes")
        times[case] = (median_ms(fn), median_ms(fnp, reps=3, warmup=1))
        device[case] = (device_ms(fn, "hiera_attn_kernel"), None)
        library[case] = median_ms(fnl)
        dev_ms = device[case][0]
        _say("hiera", f"{case}: kernel {times[case][0]:.4f} ms (device "
                      f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), plain "
                      f"{times[case][1]:.4f} ms, bound {least_ms:.4f} ms ({bounds[case][1]}), "
                      f"library (copies + SDPA) {library[case]:.4f} ms [{card}]")
        del y, qkv

    cfg = sam2_1_hiera_l()
    t1 = time.perf_counter()
    opts = tengine.PipelineOptions(max_det=16, metric_crop=128)
    pipe = tengine.CellSegmentationPipeline(sam_model_type="facebook/sam2.1-hiera-large",
                                            options=opts, device="cuda")
    frames = cell_frames(np.random.default_rng(28), b, LARGE_FRAME, cells=BIG_CELLS)
    _say("hiera", f"SAM 2.1 Hiera-L pipeline built and {b} {LARGE_FRAME} x {LARGE_FRAME} frames "
                  f"made in {time.perf_counter() - t1:.2f} s")
    by_case = collections.Counter((grid, window, pool)
                                  for grid, _, window, pool in cfg.attention())
    launches, _, _ = _drive(f"SAM 2.1 Hiera-L, {LARGE_FRAME} x {LARGE_FRAME}", pipe, frames, 16,
                            {**SAM2_COUNTS, "hiera_attention": len(cfg.blocks())},
                            hiera=dict(by_case))
    _say("hiera", f"phase {time.perf_counter() - t0:.1f} s [{card}]")
    del pipe, frames
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "bounds": bounds, "library": library, "device": device,
            "launches": launches}


def _cold_ms(fn, flush, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms by CUDA events, ``flush()`` run
    before each call outside the timed pair (the L2 left holding other data)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _resample_phase(card: str) -> dict:
    """Phase 17c: ``csrc/resample.cu`` at the 2048² cells' two resizes, 8
    gray frames as the engine holds them (a stride-0 channel view of the
    uint8 frames): the letterbox's 640 canvas and SAM's 1024. Error against
    the plain version (the dense fp32 einsum on the card) on the 0-255
    scale; the kernel timed with the L2 flushed before each call, by events
    and on the device, beside its bytes bound, the plain version and the
    benchmark's fp32 reference."""
    import numpy as np
    import torch

    from cytobench.flops import PEAK as FLOPS_PEAK
    from cytobench.reference import preprocess as ref
    from yolo_sam_inference_tpu_torch.bench.common import device_ms
    from yolo_sam_inference_tpu_torch.ops import preprocess as tpre

    t0 = time.perf_counter()
    b, side = SLICE_BATCH, LARGE_FRAME
    gray = torch.from_numpy(np.random.default_rng(30).integers(0, 256, (b, side, side),
                                                               dtype=np.uint8)).cuda()
    x = gray[..., None].expand(b, side, side, 3)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scratch.sum(dtype=torch.int32)  # noqa: E731 (a 256 MB read)
    lb_pad = float(np.float32(114.0) / np.float32(255.0))
    cases = {"letterbox 640": (640, (0.0,) * 3, (255.0,) * 3, lb_pad, ref.letterbox),
             "sam 1024": (1024, tpre.SAM_MEAN, tpre.SAM_STD, 0.0, ref.sam_pixels)}
    errs, times, bounds, library, device = {}, {}, {}, {}, {}
    for case, (size, sub, div, pad, reference) in cases.items():
        args = ((size, size), size, (0, 0), sub, div, pad)
        fn = lambda: tpre.resample_canvas(x, *args)  # noqa: E731
        fnp = lambda: tpre.resample_canvas_plain(x, *args)  # noqa: E731
        fnr = lambda: reference(gray, size)  # noqa: E731
        got, want = fn(), fnp()
        scale = torch.tensor(div, device="cuda")
        errs[case] = err = ((got - want).abs() * scale).max().item()
        _say("resample", f"{case}: kernel vs plain max |diff| {err:.3e} on the 0-255 scale")
        if not (err <= 5e-4 + 255 * 2 ** -23 and torch.isfinite(got).all()):
            raise AssertionError(f"resample {case}: the kernel disagrees with the plain version")
        del got, want
        nbytes = b * side * side + b * size * size * 3 * 4  # uint8 frames in, fp32 canvas out
        bounds[case] = (nbytes / FLOPS_PEAK["hbm"] * 1e3, "bytes")
        times[case] = (_cold_ms(fn, flush), _cold_ms(fnp, flush, reps=5, warmup=1))
        library[case] = _cold_ms(fnr, flush, reps=5, warmup=1)
        device[case] = (device_ms(lambda: (flush(), fn()), "resample_kernel"), None)
        dev_ms = device[case][0]
        _say("resample", f"{case}: kernel {times[case][0]:.4f} ms (device "
                         f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}), bound "
                         f"{bounds[case][0]:.4f} ms (bytes), plain (dense einsum) "
                         f"{times[case][1]:.4f} ms, fp32 reference {library[case]:.4f} ms, "
                         f"L2 flushed before each call [{card}]")
    del gray, x, scratch
    torch.cuda.empty_cache()
    _say("resample", f"phase {time.perf_counter() - t0:.1f} s [{card}]")
    return {"errs": errs, "times": times, "bounds": bounds, "library": library, "device": device}


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
                              CONFIG1_COUNTS, by_window={16: 8, 32: 4})

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
    import csv
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
    dpipe = _batch_copy(pipe, TIMED_BATCH)
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



def _checkpoint_phase(card: str, seeded_launches: dict) -> dict:
    """The main path from checkpoint files: state dicts drawn from a seed in
    the public namings (``bench/checkpoints.py``) written to a temporary
    directory, then (1) config 1 from YOLOv8n (ultralytics) and SAM ViT-B
    (HF, 1024-native: adapted to the 512 canvas) files, launch counts equal
    to the seeded pass's, embedding and decoder against fp32 plain, the
    build timed in turns with the seeded build; (2) ``hull_mode=
    "reference"`` on that batch against the CPU plain path on the same crops,
    the metrics stage timed in turns with the polygon's at batch 32; (3)
    MobileSAM from its file (no ``attention_bias_idxs``) with (4) YOLOv8s
    from its file, default convs and ``conv2d_fused``; (5) a missing path
    raises; then the runner on PNG files from the same checkpoints."""
    import csv
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import single_batch_inference as tapp
    from yolo_sam_inference_tpu_torch.bench import checkpoints
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, median_ms, write_png
    from yolo_sam_inference_tpu_torch.models.sam import TinyViTConfig, sam_vit_b
    from yolo_sam_inference_tpu_torch.models.yolo import yolov8n, yolov8s
    from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    tmp = tempfile.TemporaryDirectory(prefix="ysi_ckpt_")
    root = Path(tmp.name)
    paths = {name: root / f"{name}.pt" for name in ("sam_vit_b", "yolov8n", "yolov8s",
                                                      "mobile_sam")}
    t0 = time.perf_counter()
    for name, make in (
        ("sam_vit_b", lambda: checkpoints.hf_sam_state_dict(sam_vit_b(), 1)),
        ("yolov8n", lambda: checkpoints.ultralytics_state_dict(yolov8n(), 2)),
        ("yolov8s", lambda: checkpoints.ultralytics_state_dict(yolov8s(), 3)),
        ("mobile_sam", lambda: checkpoints.mobilesam_state_dict(TinyViTConfig(), sam_vit_b(), 4,
                                                                with_bias_idxs=False)),
    ):
        torch.save(make(), paths[name])
    _say("checkpoint", f"state dicts drawn and written in {time.perf_counter() - t0:.2f} s: "
                       + ", ".join(f"{n} {p.stat().st_size / 2**20:.1f} MiB"
                                   for n, p in paths.items()))
    opts = tengine.PipelineOptions(max_det=16, metric_crop=128)

    def build(mode):
        t0 = time.perf_counter()
        kw = (dict(yolo_model_path=paths["yolov8n"], sam_checkpoint=paths["sam_vit_b"])
              if mode == "files" else dict(seed=0))
        pipe = tengine.CellSegmentationPipeline(options=opts, device="cuda", **kw)
        pipe._stages(FRAME, FRAME)
        torch.cuda.synchronize()
        return pipe, time.perf_counter() - t0

    # (1) config 1 from the files; builds in turns (seeded, files, files, seeded):
    # init or load + convert, adapt to the 512 canvas, cast, upload
    builds = {"seeded": [], "files": []}
    for mode in ("seeded", "files", "files", "seeded"):
        pipe, secs = build(mode)
        builds[mode].append(secs)
        if mode == "files":
            fpipe = pipe
        del pipe
    torch.cuda.empty_cache()
    tables = {n: [lp["attn"]["rel_pos_h"].shape[0] for lp in tree["vision"]["layers"][1:3]]
              for n, tree in (("file", fpipe.sam_params),
                              ("512 canvas", fpipe._sam_params_for(fpipe._stages(FRAME,
                                                                                 FRAME)["scfg"])))}
    _say("checkpoint", f"config 1 build ms in turns (seeded, files, files, seeded): seeded "
                       f"{[round(v * 1000, 1) for v in builds['seeded']]}, from files "
                       f"{[round(v * 1000, 1) for v in builds['files']]}; rel-pos rows "
                       f"(windowed, global) {tables} [{card}]")
    if tables != {"file": [27, 127], "512 canvas": [31, 63]}:
        raise AssertionError(f"checkpoint: rel-pos tables {tables}, expected 27/127 -> 31/63")
    frames = cell_frames(np.random.default_rng(0), TIMED_BATCH, FRAME)
    launches, _, out = _drive("config 1 from files", fpipe, frames[:SLICE_BATCH], 16,
                              CONFIG1_COUNTS, by_window={16: 8, 32: 4})
    if launches != seeded_launches:
        raise AssertionError(f"config 1 from files: launches {launches}, the seeded pass's "
                             f"{seeded_launches}")
    _, emb32, _ = _embedding_vs_plain("config 1 from files", {"bf16": (fpipe, 0.05)}, frames[:1])
    _decoder_vs_plain("config 1 from files", fpipe, FRAME, emb32, out["boxes"][:1])

    # (2) the reference hull on the same batch, against the CPU plain path on
    # the same crops
    ropts = dataclasses.replace(opts, hull_mode="reference")
    rpipe = _sharing_params(fpipe, ropts)
    ref_launches, _, rout = _drive("config 1 from files, hull_mode reference", rpipe,
                                   frames[:SLICE_BATCH], 16, CONFIG1_COUNTS,
                                   by_window={16: 8, 32: 4})
    with torch.inference_mode():
        cpu = tengine.metrics_stage(
            torch.from_numpy(rout["mask_crops"]), torch.from_numpy(rout["offsets"]),
            tengine._gray_f32(torch.from_numpy(frames[:SLICE_BATCH])), (FRAME, FRAME), ropts)
    worst = 0.0
    for key, want in cpu.items():
        got, want = rout["metrics"][key], want.numpy()
        ok = (np.array_equal(got, want) if key in INT_METRIC_KEYS
              else np.allclose(got, want, rtol=1e-5, atol=1e-5))
        worst = max(worst, float(np.abs(got - want).max()))
        if not ok:
            raise AssertionError(f"hull_mode reference: {key} on the card differs from the CPU "
                                 f"plain path (max abs {np.abs(got - want).max()})")
    valid = rout["valid"]
    delta = rout["metrics"]["deformability"][valid] - out["metrics"]["deformability"][valid]
    _say("checkpoint", f"hull_mode reference: {int(valid.sum())} cells, 16 metrics equal the "
                       f"CPU plain path's (ints exact, floats rtol 1e-5; worst abs diff "
                       f"{worst:.3g}); deformability - polygon's: mean {delta.mean():.4f}, "
                       f"max {delta.max():.4f}")
    st = fpipe._stages(FRAME, FRAME)
    with torch.inference_mode():
        img = torch.from_numpy(frames).cuda()
        boxes, _, valid32 = st["detect"](img)
        crops, offs = st["segment"](st["embed"](img), boxes, valid32)
        gray = tengine._gray_f32(img)
        metric_ms = {"polygon": [], "reference": []}
        for mode in ("polygon", "reference", "reference", "polygon"):
            o = dataclasses.replace(opts, hull_mode=mode)
            metric_ms[mode].append(median_ms(
                lambda: tengine.metrics_stage(crops, offs, gray, (FRAME, FRAME), o), reps=10))
    k, cm = crops.shape[0] * crops.shape[1], crops.shape[-1]
    _say("checkpoint", f"metrics stage ms a batch of {TIMED_BATCH} ({k} crops of {cm}^2, "
                       f"{opts.num_hull_directions} directions: the reference mode's (K, h, D) "
                       f"is {k * cm * opts.num_hull_directions / 1e6:.1f} M elements) in turns: "
                       f"polygon {[round(v, 3) for v in metric_ms['polygon']]}, reference "
                       f"{[round(v, 3) for v in metric_ms['reference']]} [{card}]")
    del rpipe, img, crops, offs, gray, st
    fpipe._stage_cache.clear()
    del fpipe
    torch.cuda.empty_cache()

    # (3) MobileSAM from its file (TinyViT naming, BN statistics, no index
    # buffers) with (4) YOLOv8s from its file, default convs then conv2d_fused
    mpipe = tengine.CellSegmentationPipeline(
        yolo_model_path=paths["yolov8s"], sam_model_type="mobile-sam",
        sam_checkpoint=paths["mobile_sam"], yolo_config=yolov8s(), options=opts, device="cuda")
    mobile = {**DECODER_COUNTS, **MOBILE_ENCODER_COUNTS, "layer_norm": 10}
    mobile_launches, _, _ = _drive("mobile-sam + yolov8s from files", mpipe,
                                   frames[:SLICE_BATCH], 16, mobile)
    mrel, _, _ = _embedding_vs_plain("mobile-sam from file", {"bf16": (mpipe, 0.05)}, frames[:1],
                                     encoder_expected=MOBILE_ENCODER_COUNTS)
    vpipe = _sharing_params(mpipe, dataclasses.replace(opts, conv2d_fused=True))
    # YOLOv8s's 39 dense convs (down5 at Co 512, level 2's towers at Ci 512),
    # TinyViT's two stems and its neck's 3x3
    fused_launches, _, _ = _drive("mobile-sam + yolov8s from files, conv2d_fused", vpipe,
                                  frames[:SLICE_BATCH], 16, {**mobile, "conv2d_act": 42})
    widths = sorted({m.weight.shape[-1] for m in vpipe._stages(FRAME, FRAME)["yolo"].modules()
                     if getattr(m, "fused", False) and m.weight.ndim == 4 and m.k > 1})
    _say("checkpoint", f"yolov8s: K17's output widths on the path {widths}")
    if max(widths) != 512:
        raise AssertionError(f"yolov8s: conv2d_act widths {widths}, expected up to 512")
    yolo_rel = _yolo_vs_plain("yolov8s from file", {"conv2d_fused": vpipe, "default": mpipe},
                              frames[:1])
    del mpipe, vpipe
    torch.cuda.empty_cache()

    # (5) a path that does not exist raises; nothing falls back to random weights
    for kw in (dict(yolo_model_path=root / "missing.pt"), dict(sam_checkpoint=root / "missing.pt")):
        try:
            tengine.CellSegmentationPipeline(options=opts, device="cuda", **kw)
        except FileNotFoundError:
            continue
        raise AssertionError(f"checkpoint: {kw} did not raise FileNotFoundError")
    _say("checkpoint", "a missing yolo_model_path or sam_checkpoint raises FileNotFoundError")

    # the runner from the same files, reference hull, on PNG files
    src, dst = root / "frames", root / "out"
    src.mkdir()
    for i in range(SLICE_BATCH):
        write_png(src / f"frame_{i}.png", frames[i, ..., 0])
    t0 = time.perf_counter()
    rc = tapp.main(["--input-dir", str(src), "--output-dir", str(dst), "--yolo-model",
                    str(paths["yolov8n"]), "--sam-checkpoint", str(paths["sam_vit_b"]),
                    "--hull-mode", "reference", "--batch-size", str(SLICE_BATCH),
                    "--max-det", "16"])
    (run_dir,) = dst.iterdir()
    with open(run_dir / "cell_metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    _say("checkpoint", f"runner from the files (--hull-mode reference): rc {rc}, "
                       f"{len(rows)} rows in cell_metrics.csv, {time.perf_counter() - t0:.2f} s")
    if rc != 0 or not rows or not all(np.isfinite(float(r["deformability"])) for r in rows):
        raise AssertionError("checkpoint: the runner from files failed")
    tmp.cleanup()
    return {"launches": launches, "ref_launches": ref_launches, "builds": builds,
            "metric_ms": metric_ms, "mobile_launches": mobile_launches,
            "mobile_rel_rms": mrel["bf16"], "fused_launches": fused_launches,
            "yolo_rel_rms": yolo_rel}


def _batch_copy(pipe, batch: int, **changes):
    """``pipe``'s host trees (and, with no option changed but the batch, its
    stages) behind new options and host slots of its own."""
    import copy
    import dataclasses

    other = copy.copy(pipe)
    other.options = dataclasses.replace(pipe.options, batch_size=batch, **changes)
    if changes:
        other._stage_cache = {}
    other._slots, other._slot_next = [], 0
    return other


def _rows_against(tag: str, rows, out, j: int) -> int:
    """Metric rows (response cells or CSV rows, numbers or their text) of one
    frame against image ``j`` of ``process_batch_arrays`` outputs: the same
    cells, ints exact, floats within rtol = atol = 1e-5. Returns the cells."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS

    kept = np.flatnonzero(out["valid"][j])
    if len(rows) != len(kept):
        raise AssertionError(f"{tag}: {len(rows)} cells, process_batch_arrays {len(kept)}")
    for row, k in zip(rows, kept):
        for key in METRIC_KEYS:
            got, want = float(row[key]), float(out["metrics"][key][j, k])
            want = float(np.round(want)) if key in INT_METRIC_KEYS else want
            if not abs(got - want) <= 1e-5 + 1e-5 * abs(want):
                raise AssertionError(f"{tag}: {key} {got} against process_batch_arrays' {want}")
    return len(kept)


def _ysb1(buf: bytes) -> tuple:
    """(keys, boxes, scores, metrics, [(offset, mask)]) of a YSB1 record."""
    import struct
    import zlib

    import numpy as np

    if buf[:4] != b"YSB1":
        raise AssertionError("serve: a binary response without its YSB1 magic")
    n, nm, flags = struct.unpack_from("<III", buf, 4)
    (klen,) = struct.unpack_from("<I", buf, 16)
    keys = buf[20:20 + klen].decode().split(",")
    off = 20 + klen
    boxes = np.frombuffer(buf, "<f4", n * 4, off).reshape(n, 4)
    off += n * 16
    scores = np.frombuffer(buf, "<f4", n, off)
    off += n * 4
    metrics = np.frombuffer(buf, "<f4", n * nm, off).reshape(n, nm)
    off += n * nm * 4
    masks = []
    for _ in range(n if flags & 1 else 0):
        oy, ox, h, w, nb = struct.unpack_from("<IIIII", buf, off)
        bits = np.unpackbits(np.frombuffer(zlib.decompress(buf[off + 20:off + 20 + nb]),
                                           np.uint8))
        masks.append(([oy, ox], bits[:h * w].reshape(h, w).astype(bool)))
        off += 20 + nb
    if off != len(buf):
        raise AssertionError(f"serve: a binary record of {len(buf)} bytes ends at {off}")
    return keys, boxes, scores, metrics, masks


def _serve_phase(card: str, pipe) -> dict:
    """The port's HTTP service in-process at config 1 over ``pipe``'s stages:
    batch TIMED_BATCH, 512x512, loopback port 0. SERVE_REQUESTS requests from
    SERVE_CLIENTS client threads, three a frame of TIMED_BATCH frames (a PNG
    body with JSON and masks, a raw body with the binary record and masks, a
    PNG or raw body with JSON alone), counts set to 0 just before and read
    just after: K1-K9 per batch dispatched; each response's cells equal
    ``process_batch_arrays`` on the frames as one batch (1e-5), its masks the
    crops, the binary record the JSON, /stats counts every request. Then
    ``bench/serve.py`` for one short leg a response format."""
    import json as _json
    import threading
    import urllib.request

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench import serve as bserve
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.io.png import png_bytes
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
    from yolo_sam_inference_tpu_torch.utils.mask_encoding import decode_binary_mask
    from yolo_sam_inference_tpu_torch.web import serve as tserve

    phase_t0 = time.perf_counter()
    spipe = _batch_copy(pipe, TIMED_BATCH)
    gray = cell_frames(np.random.default_rng(2), TIMED_BATCH, FRAME)[..., 0]
    ref = spipe.process_batch_arrays(gray)
    raw = {"Content-Type": "application/octet-stream", "X-Shape": f"{FRAME}x{FRAME}"}
    png = {"Content-Type": "image/png"}
    # (frame, query, body, headers): three requests a frame
    jobs = []
    for i, frame in enumerate(gray):
        jobs += [(i, "?masks=1", png_bytes(frame, i % 5), png),
                 (i, "?masks=1&fmt=bin", frame.tobytes(), raw),
                 (i, "", png_bytes(frame, 1), png) if i % 2 else (i, "", frame.tobytes(), raw)]
    if len(jobs) != SERVE_REQUESTS:
        raise AssertionError(f"serve: {len(jobs)} requests made, SERVE_REQUESTS {SERVE_REQUESTS}")

    server, service = tserve.serve(spipe, port=0, batch_size=TIMED_BATCH, max_wait_ms=5.0,
                                   image_shape=(FRAME, FRAME))
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    results, errors, lock = {}, [], threading.Lock()

    def client():
        while True:
            with lock:
                if not jobs:
                    return
                i, query, body, headers = jobs.pop()
            try:
                req = urllib.request.Request(url + "/segment" + query, data=body,
                                             headers=headers, method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    data = r.read()
                results[i, query] = data if "fmt=bin" in query else _json.loads(data)
            except Exception as e:  # every failed request fails the phase below
                errors.append(f"{query} frame {i}: {e!r}")

    try:
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = _json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
        loop.join(timeout=5)
    if errors or any(t.is_alive() for t in clients):
        raise AssertionError(f"serve: {len(errors)} requests failed: {errors[:3]}")
    batches = stats["batches"]
    launches = _read_counts("serve", wrappers, {k: v * batches for k, v in CONFIG1_COUNTS.items()},
                            by_window={16: 8 * batches, 32: 4 * batches})
    _say("serve", f"{SERVE_REQUESTS} requests from {SERVE_CLIENTS} client threads in "
                  f"{secs:.3f} s = {SERVE_REQUESTS / secs:.2f} req/s; /stats {_json.dumps(stats)} "
                  f"[{card}]")
    if (stats["requests"], stats["images_batched"], stats["errors"]) != (SERVE_REQUESTS,
                                                                        SERVE_REQUESTS, 0):
        raise AssertionError(f"serve: /stats {stats} does not count {SERVE_REQUESTS} requests")

    cells = 0
    for i in range(TIMED_BATCH):
        resp, plain = results[i, "?masks=1"], results[i, ""]
        cells += _rows_against(f"serve frame {i} (PNG, JSON)", resp["cells"], ref, i)
        _rows_against(f"serve frame {i} (no masks)", plain["cells"], ref, i)
        kept = np.flatnonzero(ref["valid"][i])
        for m, k in zip(resp["masks"], kept):
            if m["offset"] != ref["offsets"][i, k].tolist() or not np.array_equal(
                    decode_binary_mask(m), ref["mask_crops"][i, k]):
                raise AssertionError(f"serve: frame {i} cell {k}: the mask is not the crop")
        keys, boxes, scores, metrics, masks = _ysb1(results[i, "?masks=1&fmt=bin"])
        same = (keys == list(METRIC_KEYS)
                and np.array_equal(boxes, np.asarray(resp["boxes"], np.float32))
                and np.array_equal(scores, np.asarray(resp["scores"], np.float32))
                and np.array_equal(metrics, np.asarray(
                    [[c[k] for k in keys] for c in resp["cells"]], np.float32).reshape(
                        metrics.shape))
                and len(masks) == len(resp["masks"])
                and all(o == m["offset"] and np.array_equal(b, decode_binary_mask(m))
                        for (o, b), m in zip(masks, resp["masks"])))
        if not same:
            raise AssertionError(f"serve: frame {i}: the binary record differs from the JSON")
    _say("serve", f"every response equals process_batch_arrays on the {TIMED_BATCH} frames as "
                  f"one batch ({cells} cells a format; rtol = atol = 1e-5), its masks the "
                  f"crops, each binary record its JSON")

    # the service's ceiling in this call: the collector's batch alone
    # (dispatch, then fetch, no mask bitpack), no HTTP load, bench/serve.py's frame
    frames = np.broadcast_to(bserve.bench_frame(FRAME, np.random.default_rng(0)),
                             (TIMED_BATCH, FRAME, FRAME)).copy()
    per_batch = []
    for _ in range(1 + TIMED_ITERS + 2):
        t0 = time.perf_counter()
        spipe._fetch_outputs(spipe._dispatch_batch(frames, fetch_masks=False))
        per_batch.append(time.perf_counter() - t0)
    ceiling_ms = statistics.median(per_batch[1:]) * 1e3
    _say("serve", f"the collector's batch alone (dispatch + fetch, no HTTP load): median "
                  f"{ceiling_ms:.2f} ms a batch of {TIMED_BATCH} = "
                  f"{TIMED_BATCH / ceiling_ms * 1e3:.2f} img/s (ms "
                  f"{[round(t * 1e3, 2) for t in per_batch[1:]]}) [{card}]")
    # under the bench's load: the collector's dispatch and fetch timed on the
    # pipeline instance (the bound methods shadowed for the leg alone)
    dispatch, fetch = spipe._dispatch_batch, spipe._fetch_outputs
    legs, spans = {}, {}
    for fmt in ("json", "bin"):
        spans[fmt] = {"dispatch": [], "fetch": []}

        def timed_dispatch(*a, _s=spans[fmt], **k):
            t0 = time.perf_counter()
            handle = dispatch(*a, **k)
            _s["dispatch"].append(time.perf_counter() - t0)
            return handle

        def timed_fetch(handle, _s=spans[fmt]):
            t0 = time.perf_counter()
            out = fetch(handle)
            _s["fetch"].append(time.perf_counter() - t0)
            return out

        spipe._dispatch_batch, spipe._fetch_outputs = timed_dispatch, timed_fetch
        t0 = time.perf_counter()
        try:
            legs[fmt] = bserve.run(["--batch", str(TIMED_BATCH), "--size", str(FRAME),
                                    *SERVE_BENCH_ARGS, "--fmt", fmt], "cuda", pipeline=spipe)
        finally:
            del spipe._dispatch_batch, spipe._fetch_outputs
        wall = time.perf_counter() - t0
        d_ms, f_ms = (sorted(spans[fmt][k]) for k in ("dispatch", "fetch"))
        _say("serve", f"bench/serve.py {fmt} leg: {len(d_ms)} batches in {wall:.3f} s (warm-up "
                      f"batch included); the collector's dispatch median "
                      f"{statistics.median(d_ms) * 1e3:.2f} ms, fetch "
                      f"{statistics.median(f_ms) * 1e3:.2f} ms a batch under load; busy "
                      f"{(sum(d_ms) + sum(f_ms)) / wall:.3f} of the leg [{card}]")
        if legs[fmt]["errors"]:
            raise AssertionError(f"serve: bench/serve.py {fmt} leg: {legs[fmt]['errors']} errors")
        _say("serve", f"bench/serve.py line: {_json.dumps(legs[fmt])}")
        _say("serve", f"bench/serve.py --batch {TIMED_BATCH} {' '.join(SERVE_BENCH_ARGS)} "
                      f"--fmt {fmt}: {legs[fmt]['value']} img/s, p50 "
                      f"{legs[fmt]['p50_request_latency_ms']} ms, p99 "
                      f"{legs[fmt]['p99_request_latency_ms']} ms, fill "
                      f"{legs[fmt]['mean_batch_fill']}, host CPU "
                      f"{legs[fmt]['host_cpu_ms_per_request']} ms a request [{card}]")
    _say("serve", f"phase done in {time.perf_counter() - phase_t0:.1f} s")
    return {"launches": launches, "stats": stats, "req_s": SERVE_REQUESTS / secs, "bench": legs,
            "ceiling_ms": ceiling_ms}


def _project_phase(card: str, pipe) -> dict:
    """The port's project runner, ``apps/project_inference.main``, on a tree
    of 2 conditions x 2 ``batch_*`` folders x PROJECT_FILES mode-L 512x512
    PNGs with ``--roi 100,400 --batch-size 8 --max-det 16`` (batches of 16:
    one a condition), counts set to 0 just before and read just after: K1-K9
    on both batches; the expected files; the combined CSV the per-condition
    files one after the other; the gated CSV ``filter_cells_by_roi`` of the
    combined rows and each condition's gated file its share; every row equal
    to ``process_batch_arrays`` on the same frames (1e-5)."""
    import csv
    import gc
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import project_inference as tapp
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.gate.filter import filter_cells_by_roi

    def read(path):
        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    phase_t0 = time.perf_counter()
    conds = ("cond_a", "cond_b")
    per_cond = 2 * PROJECT_FILES
    gray = cell_frames(np.random.default_rng(3), 2 * per_cond, FRAME)[..., 0]
    with tempfile.TemporaryDirectory() as td:
        root, out = Path(td) / "project", Path(td) / "out"
        names = {}
        for c, cond in enumerate(conds):
            names[cond] = []
            for b in range(2):
                (root / cond / f"batch_{b + 1}").mkdir(parents=True)
                for i in range(PROJECT_FILES):
                    name = f"b{b + 1}_f{i:02d}.png"
                    write_png(root / cond / f"batch_{b + 1}" / name,
                              gray[c * per_cond + b * PROJECT_FILES + i])
                    names[cond].append(name)
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        rc = tapp.main(["--project-dir", str(root), "--output-dir", str(out), "--roi", "100,400",
                        "--batch-size", "8", "--max-det", str(pipe.options.max_det)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = _read_counts("project", wrappers,
                                {k: 2 * v for k, v in CONFIG1_COUNTS.items()},
                                by_window={16: 16, 32: 8})
        gc.collect()  # the runner's pipeline and its device weights
        (run_dir,) = out.iterdir()
        run = run_dir.name
        want = {"cell_metrics.csv", "processing_times.csv", "run_summary.txt",
                "gated_cell_metrics.csv", "roi_coordinates.json", "pipeline_parameters.json"}
        for cond in conds:
            want |= {f"{cond}/{run}/{n}" for n in ("cell_metrics.csv", "processing_times.csv",
                                                   "condition_summary.txt",
                                                   "gated_cell_metrics.csv",
                                                   "pipeline_parameters.json")}
        files = {str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file()}
        if rc != 0 or not want <= files:
            raise AssertionError(f"project: rc {rc}, missing {sorted(want - files)}")
        combined = read(run_dir / "cell_metrics.csv")
        parts = [read(run_dir / cond / run / "cell_metrics.csv") for cond in conds]
        if combined != parts[0] + parts[1]:
            raise AssertionError("project: cell_metrics.csv is not the conditions' rows in turn")
        numeric = [{**r, "min_y": float(r["min_y"]), "max_y": float(r["max_y"])}
                   for r in combined]
        rois = {cond: {"x_min": 100, "x_max": 400, "y_min": 0, "y_max": 10**9} for cond in conds}
        gated = read(run_dir / "gated_cell_metrics.csv")
        if gated != [combined[numeric.index(r)] for r in filter_cells_by_roi(numeric, rois)]:
            raise AssertionError("project: gated_cell_metrics.csv is not the ROI gate of the rows")
        for cond in conds:
            if read(run_dir / cond / run / "gated_cell_metrics.csv") != \
                    [r for r in gated if r["condition"] == cond]:
                raise AssertionError(f"project: {cond}'s gated file is not its share")
        ppipe = _batch_copy(pipe, per_cond)
        cells = 0
        for c, (cond, rows) in enumerate(zip(conds, parts)):
            ref = ppipe.process_batch_arrays(gray[c * per_cond:(c + 1) * per_cond])
            for j, name in enumerate(names[cond]):
                cells += _rows_against(f"project {cond}/{name}",
                                       [r for r in rows if r["image_name"] == name], ref, j)
    _say("project", f"runner over 2 conditions x 2 batch folders x {PROJECT_FILES} PNGs: rc {rc} "
                    f"in {secs:.2f} s (its build included); {len(combined)} rows, {len(gated)} "
                    f"gated by --roi 100,400; every row equals process_batch_arrays on the same "
                    f"frames ({cells} cells; rtol = atol = 1e-5); the file set, the combined "
                    f"and gated CSVs checked; phase {time.perf_counter() - phase_t0:.1f} s "
                    f"[{card}]")
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": len(combined), "gated": len(gated), "secs": secs}


def _apps_phase(card: str, pipe) -> dict:
    """The int8 calibration report and the frame cleaner over TIMED_BATCH
    mode-L PNG frames, counts set to 0 just before and read just after each:
    ``run_report`` with a bf16 and a ``quant="int8"`` config-1 pipeline over
    ``pipe``'s weights (K1-K9 and K11a, K11c), its summary against
    ``compare_outputs`` of the two pipelines' own ``process_batch_arrays``
    outputs, every value finite; ``clean_frames`` with ``conv2d_fused=True``
    (YOLOv8n's 39 dense convs on K17), its counts summing to the frames,
    each frame's class that of ``classify_frame`` on ``detect_batch_arrays``,
    its files written."""
    import math
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import quant_report as tquant
    from yolo_sam_inference_tpu_torch.apps import yolo_frame_cleaner as tclean
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png

    phase_t0 = time.perf_counter()
    gray = cell_frames(np.random.default_rng(4), TIMED_BATCH, FRAME)[..., 0]
    bpipe = _batch_copy(pipe, TIMED_BATCH)
    qpipe = _batch_copy(pipe, TIMED_BATCH, quant="int8")
    fpipe = _batch_copy(pipe, TIMED_BATCH, conv2d_fused=True)
    result = {}
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "frames"
        src.mkdir()
        files = []
        for i, frame in enumerate(gray):
            files.append(src / f"frame_{i:02d}.png")
            write_png(files[-1], frame)

        wrappers = _reset_counts()
        t0 = time.perf_counter()
        summary = tquant.run_report(bpipe, qpipe, files, Path(td) / "report", TIMED_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        result["report_launches"] = _read_counts(
            "apps int8 report", wrappers,
            {**{k: 2 * v for k, v in DECODER_COUNTS.items()}, "gemm_bf16": 48 + 12,
             "window_attn_relpos": 24, "fused_ln_matmul_int8": 12, "fused_ln_mlp_int8": 12},
            by_window={16: 16, 32: 8})
        acc = {}
        rows = tquant.compare_outputs(bpipe.process_batch_arrays(gray),
                                      qpipe.process_batch_arrays(gray), TIMED_BATCH)
        for k, v in rows.items():
            acc.setdefault(k, []).extend(v)
        if summary != tquant.summarize(acc):
            raise AssertionError("apps: the report's summary differs from compare_outputs of the "
                                 "pipelines' own outputs")
        if not all(math.isfinite(v) for s in summary.values() for v in s.values()):
            raise AssertionError("apps: a non-finite value in the int8 report")
        written = sorted(p.name for p in (Path(td) / "report").iterdir())
        if written != ["quant_calibration.csv", "quant_calibration_summary.txt"]:
            raise AssertionError(f"apps: the report wrote {written}")
        iou = summary.get("iou", {})
        _say("apps", f"int8 report over {TIMED_BATCH} frames in {secs:.2f} s (the int8 stages' "
                     f"build included): {iou.get('n', 0)} matched detections, mask IoU mean "
                     f"{iou.get('mean')}, |d deformability| max "
                     f"{summary.get('deformability', {}).get('max')} (random weights: no gate "
                     f"on them); equals compare_outputs of the pipelines' own outputs [{card}]")
        qpipe._stage_cache.clear()

        wrappers = _reset_counts()
        t0 = time.perf_counter()
        counts = tclean.clean_frames(src, Path(td) / "clean", fpipe, batch_size=TIMED_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        result["cleaner_launches"] = _read_counts("apps frame cleaner", wrappers,
                                                  {"conv2d_act": 39})
        det = fpipe.detect_batch_arrays(gray)
        roi = {"x_min": 0, "y_min": 0, "x_max": FRAME, "y_max": FRAME}
        kinds = [tclean.classify_frame(det["boxes"][i], det["scores"][i], det["valid"][i], roi)[0]
                 for i in range(TIMED_BATCH)]
        if counts != {k: kinds.count(k) for k in ("target", "background", "rejected")} or \
                sum(counts.values()) != TIMED_BATCH:
            raise AssertionError(f"apps: clean_frames counts {counts}, classify_frame {kinds}")
        out = Path(td) / "clean"
        targets = [f"frame_{i:02d}.png" for i, k in enumerate(kinds) if k == "target"]
        background = [f"frame_{i:02d}.png" for i, k in enumerate(kinds) if k == "background"]
        full = targets + ([background[len(background) // 2][:-4] + "_background.png"]
                          if background else [])
        have = {d: sorted(p.name for p in (out / d).iterdir())
                for d in ("full_frames_with_target", "cropped_roi_with_target",
                          "debug_visualizations")}
        if have["full_frames_with_target"] != sorted(full) or \
                have["cropped_roi_with_target"] != targets or \
                len(have["debug_visualizations"]) != TIMED_BATCH:
            raise AssertionError(f"apps: clean_frames wrote {have}")
        _say("apps", f"frame cleaner (conv2d_fused) over {TIMED_BATCH} frames in {secs:.2f} s "
                     f"(its stages' build included): {counts}, each frame's class that of "
                     f"classify_frame on detect_batch_arrays, its files written [{card}]")
        fpipe._stage_cache.clear()
    result["picker"] = _picker_runs(card, pipe)
    _say("apps", f"phase done in {time.perf_counter() - phase_t0:.1f} s")
    torch.cuda.empty_cache()
    result["summary"] = summary
    result["counts"] = counts
    return result


def _picker_runs(card: str, pipe) -> dict:
    """The project runner on the card with ``--interactive-roi``: an HTTP
    client drives the browser picker (the page, each condition's image,
    the ROI posted) over 2 conditions x 4 mode-L 512 x 512 PNGs; counts set
    to 0 just before and read just after; then ``--roi-file`` with the same
    ROIs: the same cell and gated rows (ints exact, floats 1e-5)."""
    import gc
    import json
    import socket
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import project_inference as tapp
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.io.images import load_image
    from yolo_sam_inference_tpu_torch.io.png_native import decode_png
    from yolo_sam_inference_tpu_torch.web.app import pick_condition_image

    conds = ("cond_a", "cond_b")
    gray = cell_frames(np.random.default_rng(5), 8, FRAME)[..., 0]
    rois = {conds[0]: {"x_min": 100, "x_max": 400, "y_min": 60, "y_max": 450},
            conds[1]: {"x_min": 30, "x_max": 250, "y_min": 0, "y_max": 512}}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen, errors = {}, []

    def client():
        base = f"http://127.0.0.1:{port}"
        posted = set()
        try:
            for _ in range(600):
                try:
                    urllib.request.urlopen(base + "/health", timeout=5).read()
                    break
                except OSError:
                    time.sleep(0.1)
            seen["page"] = urllib.request.urlopen(base + "/", timeout=10).read()
            for cond in conds:
                img = urllib.request.urlopen(f"{base}/image?condition={cond}", timeout=10).read()
                seen[cond] = decode_png(img)
                req = urllib.request.Request(base + "/confirm_roi", method="POST",
                                             data=json.dumps({"condition": cond,
                                                              **rois[cond]}).encode(),
                                             headers={"Content-Type": "application/json"})
                json.loads(urllib.request.urlopen(req, timeout=10).read())
                posted.add(cond)
        except Exception as e:  # reported after the join; the picker is released below
            errors.append(e)
        finally:
            for cond in set(conds) - posted:  # never leave the runner waiting
                req = urllib.request.Request(base + "/confirm_roi", method="POST",
                                             data=json.dumps({"condition": cond,
                                                              **rois[cond]}).encode())
                try:
                    urllib.request.urlopen(req, timeout=10).read()
                except OSError:
                    pass

    with tempfile.TemporaryDirectory() as td:
        root = Path(td) / "project"
        for c, cond in enumerate(conds):
            (root / cond / "batch_1").mkdir(parents=True)
            for i in range(4):
                write_png(root / cond / "batch_1" / f"f{i}.png", gray[4 * c + i])
        common = ["--project-dir", str(root), "--batch-size", "8", "--max-det",
                  str(pipe.options.max_det)]
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        rc = tapp.main(common + ["--output-dir", str(Path(td) / "picked"), "--interactive-roi",
                                 "--port", str(port)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        thread.join(timeout=60)
        launches = _read_counts("apps interactive roi", wrappers,
                                {k: 2 * v for k, v in CONFIG1_COUNTS.items()},
                                by_window={16: 16, 32: 8})
        if errors or rc != 0:
            raise AssertionError(f"apps: the picker's client failed ({errors}) or rc {rc}")
        if b"Select ROI" not in seen["page"] or not all(
                np.array_equal(seen[c], load_image(pick_condition_image(root / c)))
                for c in conds):
            raise AssertionError("apps: the picker's page or a condition's image is wrong")
        (Path(td) / "rois.json").write_text(json.dumps(rois))
        if tapp.main(common + ["--output-dir", str(Path(td) / "file"), "--roi-file",
                               str(Path(td) / "rois.json")]) != 0:
            raise AssertionError("apps: the runner with --roi-file failed")
        (picked,) = [p for p in (Path(td) / "picked").iterdir() if p.is_dir()]
        (by_file,) = (Path(td) / "file").iterdir()
        if json.loads((picked / "roi_coordinates.json").read_text()) != rois:
            raise AssertionError("apps: the run's roi_coordinates.json is not the posted ROIs")
        n = {name: _csv_rows_match(f"apps picker {name}", picked / name, by_file / name)
             for name in ("cell_metrics.csv", "gated_cell_metrics.csv")}
    gc.collect()  # the runners' pipelines and their device weights
    _say("apps", f"project runner with --interactive-roi (the browser picker driven over HTTP "
                 f"on port {port}: page, both images, ROIs posted) in {secs:.2f} s (its build "
                 f"included): rows {n} equal to --roi-file's with the same ROIs [{card}]")
    return {"launches": launches, "rows": n, "secs": secs}


def _csv_rows_match(tag: str, got_path, want_path, rtol: float = 1e-5) -> int:
    """Two CSVs: the same header and row count, every field that is not a
    float equal, floats within ``rtol`` relative (and 1e-6 absolute).
    Returns the rows."""
    import csv

    def read(path):
        with open(path, newline="") as f:
            return list(csv.reader(f))

    got, want = read(got_path), read(want_path)
    if got[0] != want[0] or len(got) != len(want):
        raise AssertionError(f"{tag}: header {got[0]} and {len(got) - 1} rows against "
                             f"{want[0]} and {len(want) - 1}")
    for g_row, w_row in zip(got[1:], want[1:]):
        for name, g, w in zip(want[0], g_row, w_row):
            if g == w:
                continue
            try:
                gf, wf = float(g), float(w)
                ints = g.lstrip("-").isdigit() and w.lstrip("-").isdigit()
            except ValueError:
                gf = wf = ints = None
            if gf is None or ints or not abs(gf - wf) <= 1e-6 + rtol * abs(wf):
                raise AssertionError(f"{tag}: {name} {g!r} against {w!r}")
    return len(got) - 1


def _ellipse_frames(rng, n: int, size: int):
    """(uint8 (n, size, size) frames, the background): a background near 30
    (sigma 1) with 3-8 filled ellipses of 200 a frame, each drawn in its box."""
    import numpy as np

    bg = rng.normal(30, 1, size=(size, size)).clip(0, 255).astype(np.uint8)
    frames = np.repeat(bg[None], n, axis=0)
    for f in frames:
        for _ in range(rng.integers(3, 9)):
            cy, cx = rng.uniform(24, size - 24, size=2)
            ry, rx = rng.uniform(6, 18, size=2)
            r0, c0 = int(cy - ry), int(cx - rx)
            yy, xx = np.mgrid[r0:int(cy + ry) + 2, c0:int(cx + rx) + 2]
            f[r0:r0 + yy.shape[0], c0:c0 + yy.shape[1]][
                ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = 200
    return frames, bg


def _ring_stream(rng, n: int, size: int):
    """(uint8 (n, size, size) frames, the background): one ring cell a frame
    (outer radius 15-19, a hole 4-6 narrower: the inner contour's area
    within the stream gates' [250, 1200]), every 7th frame empty."""
    import numpy as np

    bg = rng.normal(30, 1, size=(size, size)).clip(0, 255).astype(np.uint8)
    frames = np.repeat(bg[None], n, axis=0)
    yy, xx = np.mgrid[:48, :48]
    for i, f in enumerate(frames):
        if i % 7 == 6:
            continue
        cy, cx = rng.uniform(40, size - 40, size=2)
        r_out = rng.uniform(15, 19)
        r_in = r_out - rng.uniform(4, 6)
        r0, c0 = int(cy) - 24, int(cx) - 24
        d2 = (yy + r0 - cy) ** 2 + (xx + c0 - cx) ** 2
        f[r0:r0 + 48, c0:c0 + 48][(d2 <= r_out ** 2) & (d2 >= r_in ** 2)] = 220
    return frames, bg


def _host_ms(fn, reps: int = 5) -> tuple:
    """(median host ms of ``fn()`` with the card idle before each call, the
    last result)."""
    import torch

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


FRAME_SIDES = (2048, 4096, 8192)  # K9 on square whole-frame masks: timed beside its bound
METRICS_FRAME = (2100, 2300)  # calculate_metrics on the card: against its CPU run and the oracle


def _frame_image_mask(h: int, w: int, seed: int):
    """A uniform random RGB (h, w, 3) uint8 image and the centred ellipse
    with semi-axes 0.45 h and 0.45 w: a whole frame for the single-cell API."""
    import numpy as np

    image = np.random.default_rng(seed).integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return image, ((yy - h / 2) / (0.45 * h)) ** 2 + ((xx - w / 2) / (0.45 * w)) ** 2 <= 1


def _frames_phase(card: str) -> dict:
    """K9's frames' kernels (a side above 256): exact against the plain
    version on 2049 x 2049 and 8192 x 8192 masks (a blob of three ellipses,
    one reaching off the frame, and the empty mask); timed by events and on
    the device at FRAME_SIDES beside the plain version and the bound; then
    ``calculate_metrics`` on the card at METRICS_FRAME in both hull modes,
    the counts set to 0 just before and read just after each call (K9 once),
    against its CPU run (ints equal, floats within 1e-5 relative, or
    absolute below 1: deformability is 1 - circularity) and the
    float64 oracle (the centroid and the brightness over the reference's
    disk, 1e-4 relative); K9 timed on that frame's mask for the table."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import device_ms, median_ms
    from yolo_sam_inference_tpu_torch.ops.hull_support import hull_support, hull_support_plain
    from yolo_sam_inference_tpu_torch.ops.metrics import (HULL_MODES, _hull_directions,
                                                          calculate_metrics)

    dev = torch.device("cuda")
    dirs = torch.from_numpy(_hull_directions(256)).to(dev)
    errs = {}
    for side in (2049, 8192):
        rng = np.random.default_rng(side)
        yy = torch.arange(side, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(side, dtype=torch.float32, device=dev)[None, :]
        masks = torch.zeros((2, side, side), dtype=torch.bool, device=dev)
        for _ in range(3):
            cy, cx = rng.uniform(0.1, 1.1, 2) * side
            ry, rx = rng.uniform(0.05, 0.4, 2) * side
            masks[0] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        for part, got, want in zip(("points", "non-empty"), hull_support(masks, dirs),
                                   hull_support_plain(masks, dirs)):
            _check(f"hull_support frame ({side} x {side}, a blob and an empty mask, 256 "
                   f"directions): {part}", got, want, 0.0, errs)
            if not torch.equal(got, want):
                raise AssertionError(f"hull_support {side}^2: the kernel's {part} differ from "
                                     f"the plain version")
        del masks, yy, xx

    def timed(mask):
        fn = lambda: hull_support(mask, dirs)
        return ((median_ms(fn), median_ms(lambda: hull_support_plain(mask, dirs))),
                device_ms(fn, "hull_support"), _hull_bound(mask, 256))

    for side in FRAME_SIDES:
        mask = torch.from_numpy(_frame_image_mask(side, side, side)[1][None]).to(dev)
        (ms, plain), dev_ms, bound = timed(mask)
        share = "" if dev_ms is None else f", {bound[0] / dev_ms:.2f} of the bound"
        parts = ", ".join(f"{k} {_fmt(device_ms(lambda: hull_support(mask, dirs), k))}"
                          for k in ("extremes", "select", "merge"))
        _say("frames", f"hull_support {side} x {side} (one frame, 256 directions): device "
                       f"{_fmt(dev_ms)} ({parts}), events {ms:.4f} ms, plain {plain:.4f} ms, "
                       f"bound {bound[0]:.4f} ms ({bound[1]}){share} [{card}]")
        del mask

    h, w = METRICS_FRAME
    image, mask = _frame_image_mask(h, w, 0)
    rows, cols = np.nonzero(mask)
    yy, xx = np.mgrid[:h, :w]
    disk = (yy - rows.mean()) ** 2 + (xx - cols.mean()) ** 2 <= int(0.1 * min(h, w)) ** 2
    gray = image.astype(np.float64).mean(axis=2)[disk]
    oracle = {"mean_brightness": gray.mean(), "brightness_std": gray.std()}
    launches = None
    for mode in HULL_MODES:
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        got = calculate_metrics(image, mask, mode, device="cuda")  # Python scalars: synced
        secs = time.perf_counter() - t0
        counts = _read_counts(f"frames calculate_metrics {h} x {w} {mode}", wrappers,
                              {"hull_support": 1})
        launches = launches or counts
        t0 = time.perf_counter()
        want = calculate_metrics(image, mask, mode, device="cpu")
        cpu_secs = time.perf_counter() - t0
        worst = 0.0  # the largest float difference, over max(|v|, 1)
        for key, v in want.items():
            same = got[key] == v if isinstance(v, int) else \
                abs(got[key] - v) <= 1e-5 * max(abs(v), 1.0)
            if type(got[key]) is not type(v) or not same:
                raise AssertionError(f"calculate_metrics {mode}: {key} on the card {got[key]} "
                                     f"against the CPU's {v}")
            if not isinstance(v, int):
                worst = max(worst, abs(got[key] - v) / max(abs(v), 1.0))
        for key, v in oracle.items():
            if abs(got[key] - v) > 1e-4 * v:
                raise AssertionError(f"calculate_metrics {mode}: {key} {got[key]} against the "
                                     f"float64 oracle's {v}")
        _say("frames", f"calculate_metrics {h} x {w}, hull_mode {mode}: 16 keys equal the CPU "
                       f"run (ints exact, floats within 1e-5 relative or absolute; the largest "
                       f"{worst:.3g}), brightness {got['mean_brightness']:.6f} / "
                       f"{got['brightness_std']:.6f} against the oracle's "
                       f"{oracle['mean_brightness']:.6f} / {oracle['brightness_std']:.6f}; the "
                       f"call {secs * 1e3:.1f} ms on the card (host clock, the copies "
                       f"included), {cpu_secs * 1e3:.1f} ms on the CPU [{card}]")
    times, dev_ms, bound = timed(torch.from_numpy(mask[None]).to(dev))
    return {"launches": launches, "errs": errs, "times": times, "device": (dev_ms, None),
            "bound": bound}


def _classical_phase(card: str) -> dict:
    """The classical path on the card, against its own CPU run:
    morphology (every function of ``ops/morphology.py`` and
    ``classical_detect_batch``) on (16, 512, 512) frames against the CPU
    port; the project runner ``apps/opencv_project_inference.main`` over 2
    conditions x CLASSICAL_FRAMES 512 x 512 PNGs with ``--thresholds 10,20
    --batch-size 16 --no-save-visualizations`` on the card (counts set to 0
    just before and read just after: K9 once a batch with a component, no
    other kernel) and with ``--device cpu``, its three CSVs against each
    other; once more on the card with visualizations on 4 frames; the
    stream runner ``apps/ms_opencv_process.main`` over STREAM_FRAMES 256 x
    256 frames of one ``images.bin`` on the card and on the CPU, its CSV
    byte-equal; K9 at a batch's cells against its plain version; frames/s of
    both runners and the split of a batch."""
    import csv
    import shutil
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import ms_opencv_process as tstream
    from yolo_sam_inference_tpu_torch.apps import opencv_project_inference as tproject
    from yolo_sam_inference_tpu_torch.bench.common import median_ms, write_png
    from yolo_sam_inference_tpu_torch.classical import ms_process as tms
    from yolo_sam_inference_tpu_torch.classical.pipeline import (
        ClassicalParams,
        ClassicalPipeline,
        gray_frames,
    )
    from yolo_sam_inference_tpu_torch.io.images import load_image
    from yolo_sam_inference_tpu_torch.io.images_bin import (
        read_frames_gray8,
        scan_frames,
        write_images_bin,
    )
    from yolo_sam_inference_tpu_torch.io.png_native import decode_png
    from yolo_sam_inference_tpu_torch.ops import morphology as tm
    from yolo_sam_inference_tpu_torch.bench.common import device_ms
    from yolo_sam_inference_tpu_torch.ops.hull_support import hull_support, hull_support_plain
    from yolo_sam_inference_tpu_torch.ops.metrics import _hull_directions

    phase_t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    result = {"errs": {}}

    # morphology on the card against the CPU port
    frames, bg = _ellipse_frames(rng, 16, CLASSICAL_SIZE)

    def morph(frames_t, bg_t):
        f = frames_t.float()
        bgb = tm.gaussian_blur(bg_t.float(), 5, 0.0)
        out = {"gaussian_blur k5": tm.gaussian_blur(f, 5, 0.0),
               "gaussian_blur k3 s1.2": tm.gaussian_blur(f, 3, 1.2),
               "contrast": tm.contrast(f, 1.2, 0.0), "absdiff": tm.absdiff(f, bgb[None]),
               "subtract_clip": tm.subtract_clip(tm.contrast(f, 1.2, 0.0), bgb[None])}
        m = tm.threshold_binary(out["absdiff"], 10.0)
        out["threshold_binary"] = m
        for it in (1, 2, 3):
            for name in ("dilate", "erode", "morph_open", "morph_close"):
                out[f"{name} {it}"] = getattr(tm, name)(m, 3, it)
        out["classical_detect_batch"] = tm.classical_detect_batch(frames_t, bgb, threshold=10.0)
        return out

    got = morph(torch.from_numpy(frames).cuda(), torch.from_numpy(bg).cuda())
    want = morph(torch.from_numpy(frames), torch.from_numpy(bg))
    masks_equal, diffs = 0, {}
    for key, ref in want.items():
        g = got[key].cpu()
        if ref.dtype == torch.bool:
            if not torch.equal(g, ref):
                raise AssertionError(f"classical: {key} on the card differs from the CPU port in "
                                     f"{int((g != ref).sum())} pixels")
            masks_equal += 1
        else:
            diffs[key] = (g - ref).abs().max().item()
            if not diffs[key] <= 1e-5:
                raise AssertionError(f"classical: {key} max |card - cpu| {diffs[key]} > 1e-5")
    _say("classical", f"morphology on the card against the CPU port at (16, {CLASSICAL_SIZE}, "
                      f"{CLASSICAL_SIZE}): {masks_equal} masks equal, max |diff| "
                      f"{ {k: float(f'{v:.3g}') for k, v in diffs.items()} } (<= 1e-5) [{card}]")
    del got, want

    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        # the project: 2 conditions x CLASSICAL_FRAMES frames, the frame cleaner's layout
        project = td / "project"
        all_frames = {}
        for c, cond in enumerate(("cond_a", "cond_b")):
            d = project / cond / "batch_1_output" / "cropped_roi_with_target"
            d.mkdir(parents=True)
            cf, cbg = _ellipse_frames(rng, CLASSICAL_FRAMES, CLASSICAL_SIZE)
            write_png(d / "background.png", cbg)
            for i, f in enumerate(cf):
                write_png(d / f"frame_{i:03d}.png", f)
            all_frames[cond] = (cf, cbg)
        argv = ["--project-dir", str(project), "--thresholds", "10,20", "--batch-size", "16",
                "--no-save-visualizations"]
        t0 = time.perf_counter()
        if tproject.main(argv + ["--output-dir", str(td / "cpu"), "--device", "cpu"]) != 0:
            raise AssertionError("classical: the project runner on the CPU failed")
        cpu_secs = time.perf_counter() - t0
        # K9 launches once a batch of 16 that has a component (no ROI: every kept one)
        expected, cpu_runs = 0, sorted((td / "cpu").iterdir())
        for run in cpu_runs:
            with open(run / "image_summary.csv", newline="") as f:
                rows = list(csv.DictReader(f))
            for cond in ("cond_a", "cond_b"):
                cells = [int(r["num_cells"]) for r in rows if r["condition"] == cond]
                expected += sum(any(cells[i:i + 16]) for i in range(0, len(cells), 16))
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        rc = tproject.main(argv + ["--output-dir", str(td / "card")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        result["launches"] = _read_counts("classical project runner", wrappers,
                                          {"hull_support": expected})
        card_runs = sorted((td / "card").iterdir())
        if rc != 0 or [p.name.split("_thresh")[1] for p in card_runs] != ["10", "20"]:
            raise AssertionError(f"classical: runner rc {rc}, runs {[p.name for p in card_runs]}")
        rows = {}
        for crun, prun in zip(card_runs, cpu_runs):
            for name in ("image_summary.csv", "cell_metrics.csv", "deformability_summary.csv"):
                rows[f"{crun.name[-8:]} {name}"] = _csv_rows_match(
                    f"classical {crun.name} {name}", crun / name, prun / name)
        n = 2 * 2 * CLASSICAL_FRAMES
        result["project_fps"] = n / secs
        _say("classical", f"project runner over 2 conditions x {CLASSICAL_FRAMES} PNGs x "
                          f"thresholds 10,20 at batch 16: card {secs:.2f} s = "
                          f"{n / secs:.1f} frames/s (files to CSV), cpu {cpu_secs:.2f} s = "
                          f"{n / cpu_secs:.1f} frames/s; K9 {expected} launches (a batch with a "
                          f"component each); CSV rows {rows} equal to the CPU run's (ints "
                          f"exact, floats 1e-5) [{card}]")

        # one batch's split on the card
        cf, cbg = all_frames["cond_a"]
        files = sorted((project / "cond_a" / "batch_1_output" /
                        "cropped_roi_with_target").glob("frame_*.png"))[:16]
        load_ms, loaded = _host_ms(lambda: [load_image(f, grayscale=True) for f in files])
        batch = np.stack(loaded)
        if not np.array_equal(batch, cf[:16]):
            raise AssertionError("classical: the PNG frames do not load back as written")
        pipe = ClassicalPipeline(ClassicalParams(threshold=10.0), device="cuda")
        pipe.preprocess_background(cbg.astype(np.float32), key="k")
        upload_ms, gray = _host_ms(lambda: gray_frames(batch, pipe.device))
        morph_ms = median_ms(lambda: pipe.detect_masks_device(gray, "k"))
        masks_dev = pipe.detect_masks_device(gray, "k")
        fetch_ms, masks = _host_ms(lambda: masks_dev.cpu().numpy())
        label_ms, comps = _host_ms(lambda: [pipe.extract_components(m) for m in masks])
        metrics_ms, _ = _host_ms(lambda: pipe.batch_metrics(comps, gray))
        ncell = sum(map(len, comps))
        split = {"load_ms": load_ms, "upload_ms": upload_ms, "morphology_ms": morph_ms,
                 "fetch_ms": fetch_ms, "label_crop_ms": label_ms, "metrics_ms": metrics_ms,
                 "cells": ncell}
        result["split"] = split
        _say("classical", f"a batch of 16 frames ({ncell} cells), ms: 16 PNGs loaded gray "
                          f"{load_ms:.3f}, upload {upload_ms:.3f}, "
                          f"device morphology {morph_ms:.3f} (events), mask fetch "
                          f"{fetch_ms:.3f}, host label + crop {label_ms:.3f}, metrics call "
                          f"(crops up, 16 metrics, rows down) {metrics_ms:.3f} (host clock) "
                          f"[{card}]")
        # K9 at this batch's cells
        crops = torch.from_numpy(np.stack([c for fr in comps for c, _ in fr])).cuda()
        dirs = torch.from_numpy(_hull_directions(256)).cuda()
        fn, ref = lambda: hull_support(crops, dirs), lambda: hull_support_plain(crops, dirs)
        for part, got, want in zip(("points", "non-empty"), fn(), ref()):
            _check(f"hull_support classical ({ncell} cells of {tuple(crops.shape[1:])} x 256 "
                   f"directions): {part}", got, want, 0.0, result["errs"])
            if not torch.equal(got, want):
                raise AssertionError(f"classical: K9's {part} differ from the plain version")
        result["k9"] = {"times": (median_ms(fn), median_ms(ref)),
                        "device": (device_ms(fn, "hull_support"), None),
                        "bound": _hull_bound(crops, 256)}
        _say("classical", f"K9 at the batch's cells: device {_fmt(result['k9']['device'][0])} "
                          f"[{card}]")

        # visualizations on 4 frames
        vis = td / "vis" / "cond_v" / "batch_1_output" / "cropped_roi_with_target"
        vis.mkdir(parents=True)
        src = project / "cond_a" / "batch_1_output" / "cropped_roi_with_target"
        for name in ["background.png"] + [f"frame_{i:03d}.png" for i in range(4)]:
            shutil.copy(src / name, vis / name)
        wrappers = _reset_counts()
        rc = tproject.main(["--project-dir", str(td / "vis"), "--output-dir", str(td / "vis_out"),
                            "--thresholds", "10", "--batch-size", "16"])
        _read_counts("classical visualizations", wrappers, {"hull_support": 1})
        (run,) = (td / "vis_out").iterdir()
        pngs = sorted(p.name for p in (run / "cond_v").iterdir())
        want_pngs = sorted(f"batch_1_output_frame_{i:03d}{s}" for i in range(4)
                           for s in ("_visualization.png", "_mask.png", "_filtered_mask.png"))
        panel = decode_png((run / "cond_v" / want_pngs[2]).read_bytes())
        if rc != 0 or pngs != want_pngs or panel.shape != (CLASSICAL_SIZE, 2 * CLASSICAL_SIZE, 3):
            raise AssertionError(f"classical: visualizations {pngs}, panel {panel.shape}")
        _say("classical", f"runner with visualizations on 4 frames: {len(pngs)} PNGs, panels "
                          f"{panel.shape} [{card}]")

        # the stream runner: one images.bin
        stream = td / "stream" / "batch_1"
        stream.mkdir(parents=True)
        sf, sbg = _ring_stream(rng, STREAM_FRAMES, STREAM_SIZE)
        write_images_bin(stream / "images.bin", list(sf))
        (stream / "roi.csv").write_text(f"x,y,width,height\n0,0,{STREAM_SIZE},{STREAM_SIZE}\n")
        write_png(stream / "background.png", sbg)
        del sf
        argv = ["--project-dir", str(td / "stream"), "--batch-size", "64"]
        wrappers = _reset_counts()
        t0 = time.perf_counter()
        rc = tstream.main(argv + ["--output-dir", str(td / "s_card")])
        torch.cuda.synchronize()
        ssecs = time.perf_counter() - t0
        _read_counts("classical stream runner", wrappers, {})
        t0 = time.perf_counter()
        rc_cpu = tstream.main(argv + ["--output-dir", str(td / "s_cpu"), "--device", "cpu"])
        scpu_secs = time.perf_counter() - t0
        card_csv = (td / "s_card" / "deformability_results.csv").read_bytes()
        same = card_csv == (td / "s_cpu" / "deformability_results.csv").read_bytes()
        nrows = card_csv.count(b"\n") - 1
        if rc or rc_cpu or not same or not STREAM_FRAMES // 2 < nrows < STREAM_FRAMES:
            raise AssertionError(f"classical: stream runner rc {rc} / {rc_cpu}, {nrows} rows, "
                                 f"the card's CSV equal to the CPU's: {same}")
        result["stream_fps"] = STREAM_FRAMES / ssecs
        _say("classical", f"stream runner over {STREAM_FRAMES} frames of {STREAM_SIZE}x"
                          f"{STREAM_SIZE} at batch 64: card {ssecs:.2f} s = "
                          f"{STREAM_FRAMES / ssecs:.1f} frames/s, cpu {scpu_secs:.2f} s = "
                          f"{STREAM_FRAMES / scpu_secs:.1f} frames/s; {nrows} valid cells, "
                          f"deformability_results.csv byte-equal [{card}]")
        # a stream batch's split
        frames_info = scan_frames(stream / "images.bin")[:64]
        decode_ms, raw = _host_ms(lambda: read_frames_gray8(stream / "images.bin", frames_info))
        cfg = tms.MsProcessingConfig()
        sbg_dev = tms.preprocess_background(sbg, cfg, device="cuda")
        sup_ms, sgray = _host_ms(lambda: gray_frames(raw, sbg_dev.device))
        smorph_ms = median_ms(lambda: tms.process_frame_batch_device(sgray, sbg_dev, cfg))
        smasks_dev = tms.process_frame_batch_device(sgray, sbg_dev, cfg)
        sfetch_ms, smasks = _host_ms(lambda: smasks_dev.cpu().numpy())
        topo_ms, _ = _host_ms(lambda: [tms.analyze_mask(m, cfg) for m in smasks])
        result["stream_split"] = {"decode_ms": decode_ms, "upload_ms": sup_ms,
                                  "morphology_ms": smorph_ms, "fetch_ms": sfetch_ms,
                                  "topology_ms_per_frame": topo_ms / 64}
        _say("classical", f"a stream batch of 64 frames, ms: images.bin decode {decode_ms:.3f}, "
                          f"upload {sup_ms:.3f}, device morphology {smorph_ms:.3f} (events), "
                          f"mask fetch {sfetch_ms:.3f}, cv2 topology {topo_ms / 64:.4f} a frame "
                          f"(host clock) [{card}]")
    _say("classical", f"phase done in {time.perf_counter() - phase_t0:.1f} s")
    torch.cuda.empty_cache()
    return result


def _registry_phase(card: str, pipe) -> dict:
    """The results store at config 1 on ``pipe``'s stages: a ``WorkManifest``
    over REGISTRY_FILES mode-L PNG frames and one unreadable file (its name
    holds ``<script>``); ``process_pending`` on the card (one
    ``process_batch_arrays`` a file, counts set to 0 just before and read
    just after: K1-K9 once a file), each stored row against
    ``process_batch_arrays`` of its frame alone (boxes, confidences, the 9
    of the 16 metrics the result schema keeps, the decoded full-frame
    mask); a second pass processes nothing; the error row; then
    ``manifest_cli`` and ``batch_readout`` once, ``build_report``, and
    ``serve_viewer`` on loopback (the table page and a row page answer 200,
    the ``<script>`` path comes back escaped)."""
    import contextlib
    import csv
    import io
    import tempfile
    import threading
    import urllib.request
    from urllib.parse import quote

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import batch_readout, manifest_cli
    from yolo_sam_inference_tpu_torch.apps.result_viewer import build_report, serve_viewer
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.registry import WorkManifest
    from yolo_sam_inference_tpu_torch.registry.manifest import metrics_to_result_row
    from yolo_sam_inference_tpu_torch.registry.nodes import process_pending
    from yolo_sam_inference_tpu_torch.reporting import write_rows_csv
    from yolo_sam_inference_tpu_torch.utils.mask_encoding import decode_binary_mask

    phase_t0 = time.perf_counter()
    n = REGISTRY_FILES
    rpipe = _batch_copy(pipe, 1)
    gray = cell_frames(np.random.default_rng(5), n, FRAME)[..., 0]
    result: dict = {}
    with tempfile.TemporaryDirectory() as td:
        src = Path(td) / "in"
        src.mkdir()
        paths = []
        for i, frame in enumerate(gray):
            write_png(src / f"f_{i:02d}.png", frame)
            paths.append(str(src / f"f_{i:02d}.png"))
        bad = src / "unreadable<script>alert(1)<.png"
        bad.write_bytes(b"not an image")
        db = Path(td) / "manifest.db"
        m = WorkManifest(db)
        m.ingest(paths + [str(bad)])
        rpipe.process_batch_arrays(gray[:1])  # warm at the one-image shape
        torch.cuda.synchronize()

        wrappers = _reset_counts()
        t0 = time.perf_counter()
        stats = process_pending(m, rpipe)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        result["launches"] = _read_counts(
            "registry", wrappers, {k: v * n for k, v in CONFIG1_COUNTS.items()},
            by_window={16: 8 * n, 32: 4 * n})
        result["fps"] = n / secs
        per_file = {k: v / n for k, v in result["launches"].items() if v}
        _say("registry", f"process_pending over {n} PNGs + 1 unreadable file: {secs:.3f} s = "
                         f"{result['fps']:.2f} files/s (one process_batch_arrays a file); "
                         f"stats {stats}; launches a file {per_file} [{card}]")
        if stats["processed"] != n or stats["errors"] != 1:
            raise AssertionError(f"registry: stats {stats}, expected {n} processed, 1 error")

        # each stored row against process_batch_arrays of the frame alone
        cells = 0
        worst = 0.0
        for i, path in enumerate(paths):
            out = rpipe.process_batch_arrays(gray[i:i + 1])
            rows = m.get_results(path)
            kept = np.flatnonzero(out["valid"][0])
            if len(rows) != len(kept):
                raise AssertionError(f"registry: {path} holds {len(rows)} cells, "
                                     f"process_batch_arrays {len(kept)}")
            cm = out["mask_crops"].shape[-1]
            for row, k in zip(rows, kept):
                want = metrics_to_result_row(rpipe._metrics_row(out["metrics"], 0, k),
                                             box=out["boxes"][0, k],
                                             confidence=out["scores"][0, k])
                want_box, got_box = want.pop("box"), row["box"]
                for key, value in [*want.items(), *((f"box {b}", want_box[b]) for b in want_box)]:
                    got = got_box[key[4:]] if key.startswith("box ") else row[key]
                    err = abs(got - value) / (1e-5 + 1e-5 * abs(value))
                    worst = max(worst, err)
                    if not err <= 1.0:
                        raise AssertionError(f"registry: {path} {key} {got} against "
                                             f"process_batch_arrays' {value}")
                full = np.zeros((FRAME, FRAME), bool)
                r0, c0 = out["offsets"][0, k]
                full[r0:r0 + cm, c0:c0 + cm] = out["mask_crops"][0, k]
                if not np.array_equal(decode_binary_mask(row["mask"]), full):
                    raise AssertionError(f"registry: {path} cell {k}: the stored mask differs")
                cells += 1
        _say("registry", f"stored rows equal process_batch_arrays of each frame alone: {cells} "
                         f"cells (boxes, confidences and the 9 stored metrics within rtol = atol "
                         f"= 1e-5, worst {worst:.3f} of it; full-frame masks exact)")
        # where a file's time goes (host clock, the device synchronised): the
        # fetch and decode, the call, the rows (masks encoded), the commit
        from yolo_sam_inference_tpu_torch.io.images import load_image
        from yolo_sam_inference_tpu_torch.utils.mask_encoding import encode_binary_mask

        split = {"load": [], "call": [], "rows": [], "commit": []}
        scratch = WorkManifest(Path(td) / "split.db")
        scratch.ingest(paths)
        for path in paths:
            t0 = time.perf_counter()
            image = load_image(path)
            t1 = time.perf_counter()
            out = rpipe.process_batch_arrays(image[None])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rows = []
            for k in np.flatnonzero(out["valid"][0]):
                full = np.zeros((FRAME, FRAME), bool)
                r0, c0 = out["offsets"][0, k]
                cm = out["mask_crops"].shape[-1]
                full[r0:r0 + cm, c0:c0 + cm] = out["mask_crops"][0, k]
                rows.append(metrics_to_result_row(rpipe._metrics_row(out["metrics"], 0, k),
                                                  mask_encoded=encode_binary_mask(full),
                                                  box=out["boxes"][0, k],
                                                  confidence=out["scores"][0, k]))
            t3 = time.perf_counter()
            scratch.record_result(path, rows)
            t4 = time.perf_counter()
            for key, a, b in (("load", t0, t1), ("call", t1, t2), ("rows", t2, t3),
                              ("commit", t3, t4)):
                split[key].append((b - a) * 1000)
        scratch.close()
        result["split_ms"] = {k: statistics.median(v) for k, v in split.items()}
        _say("registry", f"a file's ms (medians over {n}): "
                         f"{json.dumps({k: round(v, 3) for k, v in result['split_ms'].items()})}"
                         f" [{card}]")
        again = process_pending(m, rpipe)
        summary = m.summary()
        errors = [r for r in m.list_rows(limit=n + 1) if r["error"]]
        if again["processed"] != 0 or summary["errors"] != 1 or \
                [r["minio_path"] for r in errors] != [str(bad)]:
            raise AssertionError(f"registry: second pass {again}, summary {summary}, "
                                 f"errors {errors}")
        _say("registry", f"second pass {again}; summary {json.dumps(summary)}; error row "
                         f"{errors[0]['error'][:80]!r}")

        # the CLIs
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs = [manifest_cli.main(["--db", str(db), "summary"]),
                   manifest_cli.main(["--db", str(db), "pending"])]
        cli = json.loads(buf.getvalue())
        if rcs != [0, 0] or cli != summary:
            raise AssertionError(f"registry: manifest_cli rc {rcs}, summary {cli}")
        batches = Path(td) / "batches"
        flat = [{"image_name": Path(p).name, "cell_id": j, **r}
                for p in paths for j, r in enumerate(m.get_results(p))]
        for r in flat:
            r.update({f"box_{k}": v for k, v in r.pop("box").items()})
            r.pop("mask")
        half = len(flat) // 2
        for b, part in enumerate((flat[:half], flat[half:])):
            (batches / f"batch_{b + 1}").mkdir(parents=True)
            write_rows_csv(part, (), batches / f"batch_{b + 1}" / "batch_data.csv")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = batch_readout.main(["--root", str(batches)])
        with open(batches / "combined_output.csv", newline="") as f:
            combined = list(csv.DictReader(f))
        same = len(combined) == len(flat) and all(
            row["batch"] == f"batch_{1 + (j >= half)}"
            and all(str(v) == row[k] if isinstance(v, (str, int)) else
                    abs(float(row[k]) - v) <= 1e-12 * max(1.0, abs(v))
                    for k, v in want.items())
            for j, (row, want) in enumerate(zip(combined, flat)))
        if rc != 0 or not same:
            raise AssertionError(f"registry: batch_readout rc {rc}, rows equal {same}")
        _say("registry", f"manifest_cli summary / pending rc 0 (the summary equals the "
                         f"manifest's); batch_readout {buf.getvalue().strip()!r}: "
                         f"combined_output.csv holds the 2 batches' {len(flat)} rows")

        # the viewer: the static report, then the live server on loopback
        html = build_report(m, Path(td) / "report.html").read_text()
        shown = min(20, n)
        if html.count("data:image/png;base64,") != shown:
            raise AssertionError(f"registry: the report renders "
                                 f"{html.count('data:image/png;base64,')} images, expected {shown}")
        server = serve_viewer(lambda table: WorkManifest(db, table=table), ["images"],
                              "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        pages = {}
        try:
            for name, url in (("index", "/"), ("table", "/t/images"),
                              ("row", f"/t/images/row?path={quote(paths[0], safe='')}"),
                              ("bad row", f"/t/images/row?path={quote(str(bad), safe='')}")):
                with urllib.request.urlopen(base + url, timeout=30) as resp:
                    pages[name] = (resp.status, resp.read().decode())
        finally:
            server.shutdown()
            server.server_close()
        codes = {name: code for name, (code, _) in pages.items()}
        escaped = all("<script>" not in body for _, body in pages.values()) and \
            "&lt;script&gt;" in pages["table"][1] and "&lt;script&gt;" in pages["bad row"][1]
        if set(codes.values()) != {200} or not escaped or \
                "data:image/png;base64," not in pages["row"][1]:
            raise AssertionError(f"registry: viewer pages {codes}, markup escaped {escaped}")
        m.close()
    _say("registry", f"build_report renders {shown} rows; serve_viewer on loopback: pages "
                     f"{codes}, the <script> path escaped on the table and row pages; phase "
                     f"{time.perf_counter() - phase_t0:.1f} s [{card}]")
    torch.cuda.empty_cache()
    return result


def _dp_rank(rank: int, world: int, job: dict) -> None:
    """One rank of the data-parallel phase (run by parallel/launch.py in a
    process of its own): config 1 with ``mesh=make_mesh(dp=world)``, seeded
    as the parent's, on 32 and 30 frames (counts set to 0 just before the
    32 and read just after: K1-K9 once on its 16 frames), timed; then
    ``process_directory`` under the mesh over the job's PNG files, and
    ``run_sharded_directory`` + ``merge_csv_shards`` with a pipeline of its
    own (no mesh) on the same weights. Results go to ``rank<r>.npz`` and
    ``rank<r>.json`` in the job's directory."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.parallel.mesh import make_mesh
    from yolo_sam_inference_tpu_torch.parallel.multihost import (
        merge_csv_shards,
        run_sharded_directory,
    )
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    d = Path(job["dir"])
    tag = f"dp rank {rank} of {world}"
    t0 = time.perf_counter()
    opts = tengine.PipelineOptions(max_det=16, metric_crop=128, batch_size=TIMED_BATCH)
    pipe = tengine.CellSegmentationPipeline(sam_model_type="facebook/sam-vit-base",
                                            options=opts, device="cuda", seed=0,
                                            mesh=make_mesh(dp=world))
    pipe._stages(FRAME, FRAME)
    build_s = time.perf_counter() - t0
    frames = np.load(d / "frames.npy")
    pipe.process_batch_arrays(frames)  # warm at the share's shape
    torch.cuda.synchronize()
    wrappers = _reset_counts()
    out32 = pipe.process_batch_arrays(frames)
    torch.cuda.synchronize()
    launches = _read_counts(f"{tag}, its {frames.shape[0] // world} of {frames.shape[0]} "
                            "frames", wrappers, CONFIG1_COUNTS, by_window={16: 8, 32: 4})
    out_pad = pipe.process_batch_arrays(frames[:-2])  # dp does not divide: the padding
    ms = _timed(f"{tag} (mesh=make_mesh(dp={world}); {world} ranks on one card: no dp "
                "speed-up measurable)", pipe, frames, job["card"])
    arrays = {}
    for key, out in ((str(len(frames)), out32), (str(len(frames) - 2), out_pad)):
        arrays.update({f"{key}/{k}": v for k, v in out.items() if isinstance(v, np.ndarray)})
        arrays.update({f"{key}/metric_{k}": v for k, v in out["metrics"].items()})
    np.savez(d / f"rank{rank}.npz", **arrays)

    t0 = time.perf_counter()
    batch = pipe.process_directory(d / "in", d / "mesh_out", progress=False)
    torch.cuda.synchronize()
    dir_s = time.perf_counter() - t0
    local = tengine.CellSegmentationPipeline(sam_model_type="facebook/sam-vit-base",
                                             options=opts, device="cuda",
                                             params=(pipe.yolo_params, pipe.sam_params))
    t0 = time.perf_counter()
    sharded = run_sharded_directory(local, d / "in", d / "sharded_out")
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    run_dir = d / "sharded_out" / local.run_id
    merged = [merge_csv_shards(run_dir, name) for name in ("cell_metrics", "processing_times")]
    info = {"launches": launches, "ms": ms, "build_s": build_s, "dir_s": dir_s,
            "shard_s": shard_s, "run_id": pipe.run_id, "writes": pipe.writes,
            "rows": [[Path(r.image_path).name, r.cell_metrics] for r in batch.results],
            "shard_files": [Path(r.image_path).name for r in sharded.results],
            "merged": [None if p is None else str(p) for p in merged]}
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(info, f)


def _dp_phase(card: str, pipe) -> dict:
    """Data parallelism at config 1: DP_RANKS ranks through parallel/launch.py
    (gloo: both ranks share the one card), each running :func:`_dp_rank`;
    their outputs against ``pipe`` (the same seeded weights) on the same
    frames, batched as the ranks batch them and as one batch: 32 frames (16
    a rank) and 30 (the padding: 16 and 14 + 2); every rank's ``process_directory`` rows
    under the mesh against the single-card run at the share's batch; the
    merged CSVs of ``run_sharded_directory`` against the single-card rows of
    each shard's batch; then the flat-folder runner with ``--encoder-parallel
    sp --parallel-devices 2`` to rc 0, its rows against the single-card
    runner's (the cells, and each metric within the 2% relative RMS that the
    sequence-parallel slice holds its embedding to). Wall times are printed
    as two ranks on one card: no dp speed-up is measurable."""
    import csv
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.apps import single_batch_inference as tapp
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks

    phase_t0 = time.perf_counter()
    frames = cell_frames(np.random.default_rng(6), TIMED_BATCH, FRAME)[..., 0]
    files = cell_frames(np.random.default_rng(7), DP_FILES, FRAME)[..., 0]
    share = TIMED_BATCH // DP_RANKS
    result: dict = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        np.save(d / "frames.npy", frames)
        (d / "in").mkdir()
        for i, frame in enumerate(files):
            write_png(d / "in" / f"f_{i:03d}.png", frame)
        t0 = time.perf_counter()
        backend = run_ranks(_dp_rank, DP_RANKS, ({"dir": td, "card": card},))
        ranks_s = time.perf_counter() - t0
        outs = [dict(np.load(d / f"rank{r}.npz")) for r in range(DP_RANKS)]
        infos = []
        for r in range(DP_RANKS):
            with open(d / f"rank{r}.json") as f:
                infos.append(json.load(f))
        result["launches"] = infos[0]["launches"]
        _say("dp", f"{DP_RANKS} ranks over {backend} on {torch.cuda.device_count()} card(s), "
                   f"done in {ranks_s:.2f} s; builds {[round(i['build_s'], 2) for i in infos]} s")

        # the ranks' outputs: equal on every rank, and to the single card's on the shares
        for key, out in outs[0].items():
            for r in range(1, DP_RANKS):
                if not np.array_equal(outs[r][key], out):
                    raise AssertionError(f"dp: rank {r}'s {key} differs from rank 0's")
        def flat(parts, n):
            want = {k: np.concatenate([p[k] for p in parts])[:n]
                    for k in ("boxes", "scores", "valid", "offsets", "mask_crops")}
            want.update({f"metric_{k}": np.concatenate([p["metrics"][k] for p in parts])[:n]
                         for k in METRIC_KEYS})
            return want

        spipe, wpipe = _batch_copy(pipe, share), _batch_copy(pipe, TIMED_BATCH)
        for n in (TIMED_BATCH, TIMED_BATCH - 2):
            padded = np.concatenate([frames[:n], np.zeros((TIMED_BATCH - n, FRAME, FRAME),
                                                          np.uint8)])
            refs = {f"the ranks' batches of {share}": flat(
                        [spipe.process_batch_arrays(padded[s:s + share])
                         for s in range(0, TIMED_BATCH, share)], n),
                    f"one batch of {n}": flat([wpipe.process_batch_arrays(frames[:n])], n)}
            worst = 0.0
            for ref, want in refs.items():
                for key, value in want.items():
                    got = outs[0][f"{n}/{key}"]
                    if got.shape != value.shape:
                        raise AssertionError(f"dp: {n} frames {key} shape {got.shape}, "
                                             f"expected {value.shape}")
                    if value.dtype == bool or key == "offsets":
                        ok = np.array_equal(got, value)
                    else:
                        err = np.abs(got - value) / (1e-5 + 1e-5 * np.abs(value))
                        worst = max(worst, float(err.max(initial=0.0)))
                        ok = bool((err <= 1.0).all())
                    if not ok:
                        raise AssertionError(f"dp: {n} frames: {key} differs from the single "
                                             f"card's on {ref}")
            _say("dp", f"mesh=make_mesh(dp={DP_RANKS}) on {n} frames: every rank returns the "
                       f"whole batch ({n} rows), equal on all ranks and to the single card on "
                       f"the same frames, in {' and in '.join(refs)} (valid, offsets, masks "
                       f"exact; boxes, scores, metrics within 1e-5, worst {worst:.3f} of it)")

        # process_directory under the mesh: one run id, rank 0 writes, the rows
        if len({i["run_id"] for i in infos}) != 1 or \
                [i["writes"] for i in infos] != [True] + [False] * (DP_RANKS - 1):
            raise AssertionError(f"dp: run ids {[i['run_id'] for i in infos]}, writes "
                                 f"{[i['writes'] for i in infos]}")
        (mesh_run,) = (d / "mesh_out").iterdir()
        written = sorted(p.name for p in mesh_run.iterdir())
        ref = _batch_copy(pipe, share).process_directory(d / "in", d / "single_out",
                                                         progress=False)
        want_rows = [[Path(r.image_path).name, r.cell_metrics] for r in ref.results]
        cells = 0
        for info in infos:
            if [name for name, _ in info["rows"]] != [name for name, _ in want_rows]:
                raise AssertionError("dp: process_directory under the mesh gives other files")
            for (name, got), (_, want) in zip(info["rows"], want_rows):
                if len(got) != len(want):
                    raise AssertionError(f"dp: {name} has {len(got)} cells, the single card "
                                         f"{len(want)}")
                for g, w in zip(got, want):
                    for key in METRIC_KEYS:
                        if not abs(g[key] - w[key]) <= 1e-5 + 1e-5 * abs(w[key]):
                            raise AssertionError(f"dp: {name} {key} {g[key]} against {w[key]}")
                cells += len(got)
        _say("dp", f"process_directory under the mesh over {DP_FILES} PNGs: every rank's rows "
                   f"equal the single card's at batch {share} ({cells // DP_RANKS} cells; "
                   f"1e-5); one run id, rank 0 alone wrote {written}; wall s by rank "
                   f"{[round(i['dir_s'], 3) for i in infos]} ({DP_RANKS} ranks on one card: no "
                   f"dp speed-up measurable) [{card}]")

        # run_sharded_directory + merge_csv_shards: rank 0's merged rows
        merged = infos[0]["merged"]
        if merged[0] is None or any(i["merged"] != [None, None] for i in infos[1:]):
            raise AssertionError(f"dp: merged paths {[i['merged'] for i in infos]}")
        with open(merged[0], newline="") as f:
            merged_rows = list(csv.DictReader(f))
        with open(merged[1], newline="") as f:
            timing_rows = list(csv.DictReader(f))
        names = sorted(p.name for p in (d / "in").iterdir())
        if [i["shard_files"] for i in infos] != [names[r::DP_RANKS] for r in range(DP_RANKS)] \
                or sorted(r["image_name"] for r in timing_rows) != names:
            raise AssertionError("dp: the shards do not cover the files once each")
        bpipe = _batch_copy(pipe, DP_FILES // DP_RANKS)
        n_rows = 0
        for r in range(DP_RANKS):
            shard = names[r::DP_RANKS]
            ref = bpipe.process_batch_arrays(np.stack([files[names.index(n)] for n in shard]))
            for j, name in enumerate(shard):
                n_rows += _rows_against(f"dp sharded {name}",
                                        [row for row in merged_rows if row["image_name"] == name],
                                        ref, j)
        if n_rows != len(merged_rows):
            raise AssertionError(f"dp: merged {len(merged_rows)} rows, the shards {n_rows}")
        _say("dp", f"run_sharded_directory on {DP_RANKS} ranks ({DP_FILES // DP_RANKS} files a "
                   f"rank) + merge_csv_shards: rank 0's cell_metrics.csv holds the single "
                   f"card's rows of each shard's batch ({n_rows} rows; 1e-5), "
                   f"processing_times.csv every file once; wall s by rank "
                   f"{[round(i['shard_s'], 3) for i in infos]} [{card}]")

        # the flat-folder runner with --encoder-parallel sp over 2 ranks
        runs = {}
        for name, extra in (("single", []), ("sp", ["--encoder-parallel", "sp",
                                                    "--parallel-devices", str(DP_RANKS)])):
            t0 = time.perf_counter()
            rc = tapp.main(["--input-dir", str(d / "in"), "--output-dir", str(d / name),
                            "--batch-size", str(share), "--max-det", "16", *extra])
            secs = time.perf_counter() - t0
            (run_dir,) = (d / name).iterdir()
            with open(run_dir / "cell_metrics.csv", newline="") as f:
                runs[name] = (rc, secs, list(csv.DictReader(f)),
                              sorted(p.name for p in run_dir.iterdir()))
        rc, sp_secs, sp_rows, sp_files = runs["sp"]
        _, single_secs, single_rows, single_files = runs["single"]
        by_image = {}
        for tag, rows in (("sp", sp_rows), ("single", single_rows)):
            for row in rows:
                by_image.setdefault(row["image_name"], {}).setdefault(tag, []).append(row)
        same_cells = sum(len(v.get("sp", [])) == len(v.get("single", []))
                         for v in by_image.values())
        rel = {}
        for key in METRIC_KEYS:
            pairs = [(float(s[key]), float(w[key])) for v in by_image.values()
                     if len(v.get("sp", [])) == len(v.get("single", []))
                     for s, w in zip(v.get("sp", []), v.get("single", []))]
            diff = np.array([a - b for a, b in pairs])
            base = np.array([b for _, b in pairs])
            rel[key] = float(np.sqrt((diff ** 2).sum() / max((base ** 2).sum(), 1e-30)))
        worst_key = max(rel, key=rel.get)
        rel_text = json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})
        _say("dp", f"flat-folder runner --encoder-parallel sp --parallel-devices {DP_RANKS}: rc "
                   f"{rc} in {sp_secs:.2f} s (single card {single_secs:.2f} s, builds "
                   f"included; {DP_RANKS} ranks on one card: no speed-up measurable); the same "
                   f"files {sp_files == single_files}; images with the single card's cell count "
                   f"{same_cells}/{len(by_image)}; rows {len(sp_rows)} against {len(single_rows)}"
                   f"; metric rel RMS against the single-card runner, worst {worst_key} "
                   f"{rel[worst_key]:.3e} (bound 0.02), {rel_text} [{card}]")
        if rc != 0 or sp_files != single_files or same_cells != len(by_image) or \
                rel[worst_key] > 0.02:
            raise AssertionError("dp: the sequence-parallel runner's rows disagree with the "
                                 "single-card runner's")
    ms = [round(i["ms"], 2) for i in infos]
    _say("dp", f"mesh process_batch_arrays ms/batch of {TIMED_BATCH} by rank {ms} ({DP_RANKS} "
               f"ranks on one card: no dp speed-up measurable); phase "
               f"{time.perf_counter() - phase_t0:.1f} s [{card}]")
    result.update({"ms": ms, "dir_s": [i["dir_s"] for i in infos], "sp_runner_s": sp_secs,
                   "single_runner_s": single_secs, "sp_rel": rel[worst_key]})
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
    from yolo_sam_inference_tpu_torch.ops.hiera_attention import hiera_window_attention
    from yolo_sam_inference_tpu_torch.ops.hull_support import hull_support
    from yolo_sam_inference_tpu_torch.ops.preprocess import resample_canvas
    from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop

    return {"resample": resample_canvas, "gemm_bf16": tln.gemm_bf16, "window_attn_relpos": window_attention,
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
            "window_crop": window_crop, "hull_support": hull_support,
            "conv2d_act": tcv.conv2d_act, "hiera_attention": hiera_window_attention}


def _reset_counts() -> dict:
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    wrappers["window_attn_relpos"].by_window = {}
    wrappers["hiera_attention"].by_window = {}
    wrappers["flash_attention_relpos"].by_nq = {}
    wrappers["layer_norm"].residual_launches = 0
    wrappers["mbconv_block"].bf16_launches = 0
    wrappers["patch_merge_block"].bf16_launches = 0
    return wrappers


def _read_counts(tag: str, wrappers: dict, expected: dict, by_window=None, by_nq=None,
                 hiera=None) -> dict:
    """The launch counts since the reset; every kernel not in ``expected``
    must have run 0 times (the residual LayerNorm, K11d, counts as
    ``layer_norm_residual``; the compute="bf16" instantiations of K14 and
    K15 as ``mbconv_block_bf16`` and ``patch_merge_block_bf16`` too), and
    the window attention's counts by window, K12's by query count and
    Hiera's attention by (grid, window, pool) must match. The returned
    counts add K12's by query count as ``flash_attention_relpos nq<NQ>``,
    the window attention's by window as ``window_attn_relpos w<w>`` (windows
    of 16 run on one kernel, the others on K12's) and Hiera's by case as
    ``hiera_attention <case>``."""
    launches = {name: w.launches for name, w in wrappers.items()}
    launches["layer_norm_residual"] = wrappers["layer_norm"].residual_launches
    for name in ("mbconv_block", "patch_merge_block"):
        launches[f"{name}_bf16"] = wrappers[name].bf16_launches
    windows = dict(wrappers["window_attn_relpos"].by_window)
    nqs = dict(wrappers["flash_attention_relpos"].by_nq)
    cases = dict(wrappers["hiera_attention"].by_window)
    _say("slice", f"{tag}: launches {({k: v for k, v in launches.items() if v})}, attention by "
                  f"window {windows}, K12 by query count {nqs}"
                  + (f", Hiera's attention by case {cases}" if cases else ""))
    for name, n in launches.items():
        if n != expected.get(name, 0):
            raise AssertionError(f"{tag}: {name} launched {n} times, expected "
                                 f"{expected.get(name, 0)}")
    if by_window is not None and windows != by_window:
        raise AssertionError(f"{tag}: attention launches by window {windows}, expected {by_window}")
    if by_nq is not None and nqs != by_nq:
        raise AssertionError(f"{tag}: K12 launches by query count {nqs}, expected {by_nq}")
    if hiera is not None and cases != hiera:
        raise AssertionError(f"{tag}: Hiera's attention launches by case {cases}, expected {hiera}")
    launches.update({f"flash_attention_relpos nq{nq}": c for nq, c in nqs.items()})
    launches.update({f"window_attn_relpos w{w}": c for w, c in windows.items()})
    launches.update({f"hiera_attention {_hiera_case(*key)}": c for key, c in cases.items()})
    return launches


def _resamples(pipe, h: int, w: int) -> int:
    """The resample launches a batch of h x w frames makes: one for each of
    the letterbox and SAM's canvas whose resized area is not the frame's."""
    size = pipe.options.yolo_size_for(h, w)
    r = min(size / h, size / w)
    s = pipe._stages(h, w)["scfg"].image_size / max(h, w)
    return (int((round(h * r), round(w * r)) != (h, w))
            + int((int(h * s + 0.5), int(w * s + 0.5)) != (h, w)))


def _drive(tag: str, pipe, frames, max_det: int, expected: dict, by_window=None,
           by_nq=None, hiera=None) -> tuple:
    """One batch through process_batch_arrays with every count set to 0 just
    before and read just after; output shapes and finite values checked.
    Where ``expected`` names no resample count, the frames' geometry gives
    it (:func:`_resamples`)."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.ops.hull_support import hull_candidates
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS

    expected = {"resample": _resamples(pipe, frames.shape[1], frames.shape[2]), **expected}
    wrappers = _reset_counts()
    hull_candidates.calls = 0
    t0 = time.perf_counter()
    out = pipe.process_batch_arrays(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _read_counts(tag, wrappers, expected, by_window, by_nq, hiera)
    if hull_candidates.calls:  # K9 takes the masks: the plain front end stays off the card
        raise AssertionError(f"{tag}: the plain hull front end ran {hull_candidates.calls} times")
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
    # ... and the 2048² frames' resample to the letterbox's 640 and SAM's 1024
    expected = {**DECODER_COUNTS, "gemm_bf16": 4 * 32, "window_attn_relpos": 32, "resample": 2}
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
    pipe = tengine.CellSegmentationPipeline(sam_model_type="mobile-sam", options=opts,
                                            device="cuda", seed=0)
    # the init's biases, LN shifts and attention bias tables are 0 (scales
    # 1): drawn at random here, so the pad-token qkv row, the bias tables and
    # the expanded halo's gelu(b1) reach the embedding check
    _randomise_affines(pipe.sam_params["tinyvit"], np.random.default_rng(7))
    pipe._stages(FRAME, FRAME)
    _say("slice", f"mobile-sam: pipeline built (init + cast + upload) "
                  f"{time.perf_counter() - t0:.2f} s")
    frames = cell_frames(np.random.default_rng(6), TIMED_BATCH, FRAME)
    encoder = MOBILE_ENCODER_COUNTS
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


def _vit_512(model: str):
    """SAM config of ``model`` at the 512 canvas (grid 32, window 16)."""
    import dataclasses

    from yolo_sam_inference_tpu_torch.models.sam import sam_vit_b, sam_vit_h

    base = {"vit-b": sam_vit_b, "vit-h": sam_vit_h}[model]()
    return dataclasses.replace(base, image_size=FRAME, window_size=16)


def _encoders_single(tree, cfg, pix):
    """(bf16 kernel embedding, fp32 plain embedding on the bf16-rounded
    weights, the kernel encoder's median ms) of the single card, on the
    normalised pixels ``pix`` (fp32, on the card)."""
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    _, sam = from_jax_params(None, tree, "cuda", torch.bfloat16, sam_config=cfg)
    pix16 = pix.to(torch.bfloat16)
    with torch.inference_mode():
        emb16 = sam.vision(pix16).float()
        ms = median_ms(lambda: sam.vision(pix16), reps=5, warmup=1)
    del sam
    _, sam32 = from_jax_params(None, tengine._round_floating(tree, torch.bfloat16), "cuda",
                               torch.float32, sam_config=cfg)
    with torch.inference_mode():
        emb32 = sam32.vision(pix, plain=True)
    del sam32
    torch.cuda.empty_cache()
    return emb16, emb32, ms


def _outputs_agree(tag: str, got: dict, want: dict) -> dict:
    """A multi-rank engine's outputs against the single card's on the same
    frames: boxes, scores and detections exactly (YOLO runs the same kernels
    on the same frames), the masks of the valid cells on at least 99% of
    pixels, each metric within 2% relative RMS (the bound the
    sequence-parallel slice holds its embedding to)."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS

    for key in ("boxes", "scores", "valid"):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(f"{tag}: {key} differ from the single card's")
    valid = want["valid"]
    agree = float((got["mask_crops"][valid] == want["mask_crops"][valid]).mean())
    rels = {}
    for key in METRIC_KEYS:
        g, w = got[f"metric_{key}"][valid], want["metrics"][key][valid]
        rels[key] = float(np.linalg.norm(g - w) / max(float(np.linalg.norm(w)), 1e-30))
    worst = max(rels, key=rels.get)
    exact = agree == 1.0 and max(rels.values()) == 0.0
    _say("tp", f"{tag}: {int(valid.sum())} valid cells; boxes, scores, detections equal the "
               f"single card's; masks agree on {agree:.6f} of their pixels; worst metric "
               f"{worst} rel_rms {rels[worst]:.3e}{' (all outputs bit-equal)' if exact else ''}")
    if agree < 0.99 or rels[worst] > 0.02:
        raise AssertionError(f"{tag}: outputs disagree with the single card's")
    return {"mask_agree": agree, "worst_metric_rel": rels[worst]}


def _tp_rank(rank: int, world: int, job: dict) -> None:
    """One of MESH_RANKS ranks of ``[tp]`` (run by parallel/launch.py in a
    process of its own). Ranks 0-1 (a group of TP_RANKS): each holds only its
    shard of ViT-B and of ViT-H (the parent's files) and runs the
    tensor-parallel encoder on the frames (launch counts, embedding, median
    ms), then config 1 with ``encoder_parallel="tp"`` on the pair
    (``_drive``). All four: config 1 on a (dp 2, sp 2) and a (dp 2, tp 2)
    mesh, each rank's launch counts on its share. Results go to the job's
    directory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.models.sam import SamImageEncoder
    from yolo_sam_inference_tpu_torch.parallel.mesh import make_mesh, make_mesh_axes
    from yolo_sam_inference_tpu_torch.parallel.tp import sam_image_encoder_tp
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import load_tree

    d = Path(job["dir"])
    pair = dist.new_group(list(range(TP_RANKS)))  # new_group and meshes: on every rank
    meshes = {"dp 2 x sp 2": (make_mesh_axes(dp=2, sp=2), "sp"),
              "dp 2 x tp 2": (make_mesh(dp=2, tp=2), "tp")}
    frames = np.load(d / "frames.npy")
    trees = load_tree(d / "params.npz")
    info: dict = {}
    if rank < TP_RANKS:
        pix = torch.from_numpy(np.load(d / "pix.npy")).cuda().to(torch.bfloat16)
        for model, cfg in job["cfgs"].items():
            enc = SamImageEncoder(load_tree(d / f"{model}.shard{rank}.npz"), cfg)
            enc = enc.to("cuda", torch.bfloat16)
            layers = cfg.vision_layers
            tag = f"tp {model} rank {rank} of {TP_RANKS}"
            with torch.inference_mode():
                wrappers = _reset_counts()
                emb = sam_image_encoder_tp(enc, pix, cfg, pair)
                torch.cuda.synchronize()
                info[f"{model} launches"] = _read_counts(
                    f"{tag}, the encoder alone ({frames.shape[0]} frames)", wrappers,
                    {"gemm_bf16": 4 * layers, "window_attn_relpos": layers, "layer_norm": 2},
                    by_window={16: layers - 4, 32: 4})
                # the counted call above warmed it; the gloo all-reduces take seconds
                info[f"{model} ms"] = median_ms(lambda: sam_image_encoder_tp(enc, pix, cfg, pair),
                                                reps=3, warmup=0)
            np.save(d / f"{model}.emb{rank}.npy", emb.float().cpu().numpy())
            del enc, emb
            torch.cuda.empty_cache()
        opts = tengine.PipelineOptions(max_det=16, metric_crop=128, encoder_parallel="tp")
        pipe = tengine.CellSegmentationPipeline(sam_model_type="facebook/sam-vit-base",
                                                options=opts, device="cuda", process_group=pair,
                                                params=(trees["yolo"], trees["sam"]))
        info["engine launches"], _, out = _drive(
            f"tp engine rank {rank} of {TP_RANKS} (encoder_parallel='tp')", pipe, frames, 16,
            CONFIG1_COUNTS, by_window={16: 8, 32: 4})
        _save_outputs(d / f"engine.rank{rank}.npz", out)
        del pipe
        torch.cuda.empty_cache()
    expected = {"dp 2 x sp 2": ({**DECODER_COUNTS, "gemm_bf16": 48, "window_attn_relpos": 8,
                                 "flash_attention_relpos": 4}, {16: 8}, {512: 4}),
                "dp 2 x tp 2": (CONFIG1_COUNTS, {16: 8, 32: 4}, None)}
    for name, (mesh, kind) in meshes.items():
        opts = tengine.PipelineOptions(max_det=16, metric_crop=128, encoder_parallel=kind)
        pipe = tengine.CellSegmentationPipeline(sam_model_type="facebook/sam-vit-base",
                                                options=opts, device="cuda", mesh=mesh,
                                                params=(trees["yolo"], trees["sam"]))
        counts, by_window, by_nq = expected[name]
        wrappers = _reset_counts()
        out = pipe.process_batch_arrays(frames)
        torch.cuda.synchronize()
        info[f"{name} launches"] = _read_counts(
            f"{name} rank {rank}, its {frames.shape[0] // 2} of {frames.shape[0]} frames",
            wrappers, counts, by_window, by_nq)
        _save_outputs(d / f"{name.replace(' ', '')}.rank{rank}.npz", out)
        del pipe
        torch.cuda.empty_cache()
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump(info, f)


def _save_outputs(path, out: dict) -> None:
    import numpy as np

    arrays = {k: v for k, v in out.items() if isinstance(v, np.ndarray)}
    arrays.update({f"metric_{k}": v for k, v in out["metrics"].items()})
    np.savez(path, **arrays)


def _tp_phase(card: str, vit_b_pipe, vit_h_pipe) -> dict:
    """``[tp]``: the tensor-parallel encoder at full width on TP_RANKS gloo
    ranks sharing the card, ViT-B (config 1's weights, 512² frames) and
    ViT-H (16 heads: 8 a rank, hd 80), each with the tables, embeddings,
    biases and affines that the earlier phases drew at random: the ranks'
    embeddings equal, against the single card's bf16 kernel encoder (2%)
    and the fp32 plain encoder (5%), the gates of ``[sp]``; config 1 with
    ``encoder_parallel="tp"`` and on (dp 2, sp 2) and (dp 2, tp 2) meshes of
    MESH_RANKS ranks, against the single card on the same frames; and
    ``gemm_bf16`` at the row-parallel products' K (384 and 640) against its
    fp32 plain version, timed beside ``torch.mm``."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, median_ms
    from yolo_sam_inference_tpu_torch.models.sam import adapt_resolution
    from yolo_sam_inference_tpu_torch.ops.fused_ln import gemm_bf16, gemm_plain
    from yolo_sam_inference_tpu_torch.ops.preprocess import sam_preprocess_batch
    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
    from yolo_sam_inference_tpu_torch.parallel.tp import shard_sam_encoder_tp
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.weights import save_tree

    phase_t0 = time.perf_counter()
    result: dict = {"errs": {}, "times": {}, "bounds": {}, "library": {}}
    # the row-parallel products of a tp rank: proj (K = C / tp) and mlp2
    # (K = hidden / tp); their K is below one 128-wide tile pair's worth
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(18)
    for tag, k, n in (("ViT-B", 384, 768), ("ViT-H", 640, 1280)):
        a = torch.randn(KERNEL_ROWS, k, generator=g).to(dev, bf)
        w = (torch.randn(k, n, generator=g) * k ** -0.5).to(dev, bf)
        got = gemm_bf16(a, w)
        key = f"tp {tag} K{k}"
        _check(f"gemm_bf16 {key} row-parallel proj ({KERNEL_ROWS}x{k} @ {k}x{n})", got,
               gemm_plain(a.float(), w.float()), 2e-2, result["errs"])
        result["times"][key] = (median_ms(lambda: gemm_bf16(a, w)),
                                median_ms(lambda: gemm_plain(a.float(), w.float())))
        result["library"][key] = median_ms(lambda: torch.mm(a, w))
        result["bounds"][key] = _bound(2.0 * KERNEL_ROWS * k * n, _nbytes(a, w, got))
        _say("tp", f"gemm_bf16 {key}: {result['times'][key][0]:.4f} ms (plain fp32 "
                   f"{result['times'][key][1]:.4f}, torch.mm bf16 {result['library'][key]:.4f}, "
                   f"bound {result['bounds'][key][0]:.4f} {result['bounds'][key][1]}) [{card}]")
        del a, w, got
    frames = cell_frames(np.random.default_rng(18), SLICE_BATCH, FRAME)
    pix, _, _ = sam_preprocess_batch(torch.from_numpy(frames).cuda(), FRAME)
    cfgs = {"vit-b": _vit_512("vit-b"), "vit-h": _vit_512("vit-h")}
    pipes = {"vit-b": vit_b_pipe, "vit-h": vit_h_pipe}
    single = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for model, cfg in cfgs.items():
            tree = adapt_resolution(pipes[model].sam_params, cfg)
            for r in range(TP_RANKS):
                save_tree(f"{tmp}/{model}.shard{r}.npz",
                          shard_sam_encoder_tp(tree, cfg, TP_RANKS, r)["vision"])
            single[model] = _encoders_single(tree, cfg, pix)
            del tree
        save_tree(f"{tmp}/params.npz", {"yolo": vit_b_pipe.yolo_params,
                                        "sam": vit_b_pipe.sam_params})
        np.save(f"{tmp}/frames.npy", frames)
        np.save(f"{tmp}/pix.npy", pix.cpu().numpy())
        _say("tp", f"shards of ViT-B and ViT-H, the single-card embeddings and the config-1 "
                   f"trees written for the ranks in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        backend = run_ranks(_tp_rank, MESH_RANKS, ({"dir": tmp, "cfgs": cfgs},))
        _say("tp", f"backend {backend}, {MESH_RANKS} ranks on {torch.cuda.device_count()} "
                   f"card(s); ranks done in {time.perf_counter() - t0:.2f} s")
        infos = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(MESH_RANKS)]
        embs = {m: [np.load(f"{tmp}/{m}.emb{r}.npy") for r in range(TP_RANKS)] for m in cfgs}
        outs = {name: [dict(np.load(f"{tmp}/{name}.rank{r}.npz")) for r in range(n)]
                for name, n in (("engine", TP_RANKS), ("dp2xsp2", MESH_RANKS),
                                ("dp2xtp2", MESH_RANKS))}
    for model in cfgs:
        emb16, emb32, ms = single[model]
        got = embs[model]
        if not all(np.array_equal(e, got[0]) for e in got[1:]):
            raise AssertionError(f"tp {model}: the ranks' embeddings differ")
        e16, e32 = emb16.cpu().numpy(), emb32.cpu().numpy()
        rel16 = float(np.linalg.norm(got[0] - e16) / np.linalg.norm(e16))
        rel32 = float(np.linalg.norm(got[0] - e32) / np.linalg.norm(e32))
        result[f"{model} rel16"], result[f"{model} rel32"] = rel16, rel32
        rank_ms = [info[f"{model} ms"] for info in infos[:TP_RANKS]]
        result[f"{model} ms"], result[f"{model} single ms"] = rank_ms, ms
        _say("tp", f"{model} encoder at tp={TP_RANKS} ({got[0].shape}): equal on all ranks; "
                   f"rel_rms vs the single-card bf16 encoder {rel16:.3e} (bound 0.02), vs the "
                   f"fp32 plain encoder {rel32:.5f} (bound 0.05); ms by rank {rank_ms}, the "
                   f"single card {ms:.3f} (two ranks sharing one card: no tp speed) [{card}]")
        if not (rel16 <= 0.02 and rel32 <= 0.05 and np.isfinite(got[0]).all()):
            raise AssertionError(f"tp {model}: the tensor-parallel embedding disagrees with the "
                                 "single-card encoders")
    ref_pipe = _sharing_params(vit_b_pipe, tengine.PipelineOptions(max_det=16, metric_crop=128))
    ref_pipe._adapted_params.clear()  # adapt the trees the ranks adapt, as they are now
    want = ref_pipe.process_batch_arrays(frames)
    for name, runs in outs.items():
        for r, got in enumerate(runs):
            result[f"{name} rank {r}"] = _outputs_agree(f"{name} rank {r}", got, want)
    result["launches"] = {name: infos[0][f"{name} launches"]
                          for name in ("vit-b", "vit-h", "engine", "dp 2 x sp 2", "dp 2 x tp 2")}
    ref_pipe._stage_cache.clear()
    torch.cuda.empty_cache()
    result["secs"] = time.perf_counter() - phase_t0
    _say("tp", f"phase {result['secs']:.2f} s")
    return result


# the train step's forward a batch: the encoder's and the decoder's kernels of
# the inference path; no crop, no hull (the mask head runs on the whole grid)
TRAIN_COUNTS = {k: v for k, v in CONFIG1_COUNTS.items() if k not in ("window_crop",
                                                                      "hull_support")}
# leaves the loss does not reach: the point prompt, the hypernetworks of masks
# 1-3 (multimask_output=False)
UNREACHED = ("prompt::not_a_point", "decoder::hyper_mlps::1::", "decoder::hyper_mlps::2::",
             "decoder::hyper_mlps::3::")


def _grad_stats(grads: dict, ref: dict, keys) -> dict:
    """(cosine, |g| / |g_ref|) of step 1's gradients per tensor of ``keys``.
    The attention key biases' true gradient is zero (a softmax drops a shift
    of a query's logits), so both sides are rounding noise there: a fused qkv
    bias is taken at its q and v thirds (``::k::b`` is not in ``keys``)."""
    import torch

    out = {}
    for k in keys:
        a = grads[k].double().flatten()
        b = ref[k].double().flatten().to(a.device)
        if k.endswith("attn::qkv::b"):
            third = a.numel() // 3
            keep = torch.cat([torch.arange(third), torch.arange(2 * third, 3 * third)])
            a, b = a[keep.to(a.device)], b[keep.to(a.device)]
        out[k] = (float((a @ b) / (a.norm() * b.norm()).clamp(min=1e-300)),
                  float(a.norm() / b.norm().clamp(min=1e-300)))
    return out


def _gate_grads(tag: str, stats: dict) -> dict:
    """Says the worst cosine and norm ratio of ``stats`` and raises past
    GRAD_COS_MIN / GRAD_NORM_TOL."""
    by_cos = sorted(stats, key=lambda k: stats[k][0])
    by_ratio = sorted(stats, key=lambda k: -abs(stats[k][1] - 1))
    ratios = [r for _, r in stats.values()]
    _say("train", f"{tag}: cosine over {len(stats)} tensors min {stats[by_cos[0]][0]:.6f} "
                  f"({by_cos[0]}), next {[(k, round(stats[k][0], 6)) for k in by_cos[1:3]]}, "
                  f"median {statistics.median(c for c, _ in stats.values()):.6f} (bound "
                  f"{GRAD_COS_MIN}); norm ratio |g|/|g_ref| from {min(ratios):.6f} to "
                  f"{max(ratios):.6f}, worst {by_ratio[0]} (bound 1 +- {GRAD_NORM_TOL})")
    if stats[by_cos[0]][0] < GRAD_COS_MIN or abs(stats[by_ratio[0]][1] - 1) > GRAD_NORM_TOL:
        raise AssertionError(f"train: {tag}: the gradients disagree")
    return {"min_cos": stats[by_cos[0]][0], "worst_cos": by_cos[0],
            "worst_ratio": stats[by_ratio[0]][1], "worst_ratio_key": by_ratio[0]}


def _train_batch(cfg, n: int):
    """The [train] batch: n frames of 12 cells normalised as the engine does,
    TRAIN_BOXES boxes a frame and 128² random target masks from a seed."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.ops.preprocess import sam_preprocess_batch

    rng = np.random.default_rng(19)
    frames = cell_frames(rng, n, FRAME)
    pix, _, _ = sam_preprocess_batch(torch.from_numpy(frames), cfg.image_size)
    xy = rng.uniform(0, FRAME - 80, size=(n, TRAIN_BOXES, 2))
    wh = rng.uniform(16, 80, size=(n, TRAIN_BOXES, 2))
    low = cfg.low_res_size
    return {"images": pix.numpy().astype(np.float32),
            "boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "masks": (rng.random((n, TRAIN_BOXES, low, low)) > 0.5).astype(np.float32),
            "valid": np.ones((n, TRAIN_BOXES), np.float32)}


def _train_rank(rank: int, world: int, job: dict) -> None:
    """One of MESH_RANKS ranks of [train]'s dp 2 x tp 2 run (parallel/launch.py):
    the state on the mesh from the parent's tree, 2 steps on the parent's
    batch (launch counts of step 1 on the rank's share); the losses, a digest
    of the parameters that tp does not split and one of those it splits go
    to ``rank<r>.json``, step 1's gradients gathered to one tree (as reduced
    over the mesh) to ``grads1.npz`` by rank 0."""
    import hashlib

    import numpy as np
    import torch

    import yolo_sam_inference_tpu_torch.parallel.train as ttrain
    from yolo_sam_inference_tpu_torch.parallel.mesh import make_mesh
    from yolo_sam_inference_tpu_torch.utils.checkpoint import flatten_tree
    from yolo_sam_inference_tpu_torch.weights import load_tree

    d = Path(job["dir"])
    mesh = make_mesh(dp=2, tp=2)
    cfg = job["cfg"]
    state = ttrain.make_train_state(0, cfg, mesh, params=load_tree(d / "tree.npz"),
                                    learning_rate=TRAIN_LR)
    with np.load(d / "batch.npz") as z:
        batch = dict(z)
    losses, timings = [], {}
    for step in range(2):
        wrappers = _reset_counts()
        state, loss = ttrain.sam_decoder_train_step(state, batch, cfg, timings=timings)
        if step == 0:
            launches = _read_counts(f"train dp 2 x tp 2 rank {rank}, step 1", wrappers,
                                    TRAIN_COUNTS, by_window={16: 8, 32: 4})
            grads = ttrain.gather_params(state, grads=True)  # a collective over tp
            if rank == 0:
                np.savez(d / "grads1.npz", **flatten_tree(grads))
            del grads
        losses.append(loss)
    digests = {"replicated": hashlib.sha1(), "sharded": hashlib.sha1()}
    for key, p in state["params"].items():
        kind = ("sharded" if key.startswith("vision::layers::") and key.endswith(ttrain.TP_SHARDED)
                else "replicated")
        digests[kind].update(p.detach().cpu().numpy().tobytes())
    torch.cuda.synchronize()
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump({"losses": losses, "launches": launches,
                   "ms": {k: v * 1000 / 2 for k, v in timings.items()},
                   **{k: h.hexdigest() for k, h in digests.items()}}, f)


def _train_phase(card: str, vit_b_pipe) -> dict:
    """``[train]``: the SAM fine-tune step at ViT-B's full width on the 512
    canvas config 1 runs (grid 32, windows 16 / 32; the tree of
    ``adapt_resolution`` from config 1's weights, as the earlier phases left
    them), SLICE_BATCH frames x TRAIN_BOXES boxes, 128² random targets,
    TRAIN_STEPS AdamW steps on the card: step 1's gradients against fp32 plain
    autograd on the card (cosine and norm ratio per tensor), every leaf the
    loss reaches with a non-zero gradient, the forward's launch counts those
    of inference, the loss falling, each step's forward / backward / update
    ms; then 2 steps on a dp 2 x tp 2 mesh of MESH_RANKS gloo ranks sharing
    the card against the single card's first 2, and its step 1 gradients,
    gathered, against the single card's. Learning rate TRAIN_LR (its note
    says why)."""
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.models.sam import adapt_resolution
    import yolo_sam_inference_tpu_torch.parallel.train as ttrain
    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
    from yolo_sam_inference_tpu_torch.weights import save_tree

    phase_t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    cfg = _vit_512("vit-b")
    tree = adapt_resolution(vit_b_pipe.sam_params, cfg)
    batch = _train_batch(cfg, SLICE_BATCH)
    state = ttrain.make_train_state(0, cfg, params=tree, learning_rate=TRAIN_LR)
    dev = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    # the oracle: step 1's gradients by fp32 plain autograd on the same masters
    t0 = time.perf_counter()
    logits, iou = ttrain.forward(state, dev["images"], dev["boxes"], cfg, plain=True)
    total, count = ttrain.loss_terms(logits, iou, dev["masks"], dev["valid"])
    keys = list(state["params"])
    ref = torch.autograd.grad(total / count, [state["params"][k] for k in keys],
                              allow_unused=True)
    ref = {k: (torch.zeros_like(state["params"][k]) if g is None else g) for k, g in zip(keys, ref)}
    loss32 = (total / count).item()
    del logits, iou, total
    torch.cuda.synchronize()
    _say("train", f"fp32 plain autograd on the card: loss {loss32:.6f} "
                  f"({time.perf_counter() - t0:.2f} s)")

    losses, steps_ms = [], []
    for step in range(TRAIN_STEPS):
        timings: dict = {}
        wrappers = _reset_counts()
        state, loss = ttrain.sam_decoder_train_step(state, batch, cfg, timings=timings)
        if step == 0:
            launches = _read_counts("train step 1 (the forward; the backward runs the plain "
                                    "versions)", wrappers, TRAIN_COUNTS,
                                    by_window={16: 8, 32: 4})
            grads = {k: p.grad.detach().clone() for k, p in state["params"].items()}
        losses.append(loss)
        steps_ms.append({k: v * 1000 for k, v in timings.items()})
        _say("train", f"step {step + 1}: loss {loss:.6f}; ms " + json.dumps(
            {k: round(v, 3) for k, v in steps_ms[-1].items()}) + f" [{card}]")

    unreached = {k for k in keys if k.startswith(UNREACHED)}
    zero = {k for k, g in grads.items() if not bool(g.abs().sum() > 0)}
    zero_ref = {k for k, g in ref.items() if not bool(g.abs().sum() > 0)}
    _say("train", f"{len(keys) - len(zero)} of {len(keys)} leaves have a non-zero gradient; "
                  f"the {len(zero)} others are the leaves the loss does not reach "
                  f"({sorted(zero)[:3]}...)")
    if zero != unreached or zero_ref != unreached:
        raise AssertionError(f"train: zero gradients on {sorted(zero ^ unreached)} (oracle "
                             f"{sorted(zero_ref ^ unreached)})")
    compared = [k for k in keys if k not in unreached and not k.endswith("::k::b")]
    agree = _gate_grads("step 1 gradients (bf16 kernels, plain backward) vs fp32 plain "
                        "autograd", _grad_stats(grads, ref, compared))
    rel_loss = abs(losses[0] - loss32) / loss32
    _say("train", f"step 1 loss {losses[0]:.6f} vs fp32 plain autograd's {loss32:.6f} (rel "
                  f"{rel_loss:.2e}, bound 0.02)")
    if rel_loss > 0.02:
        raise AssertionError("train: the kernels' loss disagrees with fp32 plain autograd")
    if not all(np.isfinite(losses)) or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"train: the loss does not fall: {losses}")
    later = steps_ms[1:]
    split = {k: statistics.median(s[k] for s in later) for k in later[0]}
    share = split["backward"] / sum(split.values())
    _say("train", f"losses {losses} (learning rate {TRAIN_LR}); step ms (median of steps "
                  f"2-{TRAIN_STEPS}) " + json.dumps({k: round(v, 3) for k, v in split.items()})
                  + f", backward {share:.3f} of the step [{card}]")
    default = ttrain.make_train_state(0, cfg, params=tree)
    rates = [ttrain.sam_decoder_train_step(default, batch, cfg)[1] for _ in range(2)]
    _say("train", f"at optax's default learning rate 1e-4 from the same weights: losses {rates}")
    del default

    with tempfile.TemporaryDirectory() as tmp:
        save_tree(f"{tmp}/tree.npz", tree)
        np.savez(f"{tmp}/batch.npz", **batch)
        t0 = time.perf_counter()
        backend = run_ranks(_train_rank, MESH_RANKS, ({"dir": tmp, "cfg": cfg},))
        infos = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(MESH_RANKS)]
        with np.load(f"{tmp}/grads1.npz") as z:
            mesh_grads = {k: torch.from_numpy(z[k]) for k in compared}
    mesh_agree = _gate_grads("dp 2 x tp 2 step 1 gradients, reduced over the mesh and "
                             "gathered, vs the single card's", _grad_stats(mesh_grads, grads,
                                                                            compared))
    del mesh_grads
    _say("train", f"dp 2 x tp 2 on {MESH_RANKS} ranks ({backend}, one card) in "
                  f"{time.perf_counter() - t0:.2f} s: losses by rank "
                  f"{[i['losses'] for i in infos]}; ms a step rank 0 " + json.dumps(
                      {k: round(v, 3) for k, v in infos[0]["ms"].items()}))
    for info in infos:
        rel = max(abs(a - b) / b for a, b in zip(info["losses"], losses[:2]))
        if rel > 0.01:
            raise AssertionError(f"train dp x tp: losses {info['losses']} against the single "
                                 f"card's {losses[:2]}")
    if len({i["replicated"] for i in infos}) != 1:
        raise AssertionError("train dp x tp: the replicated parameters differ across ranks")
    if infos[0]["sharded"] != infos[2]["sharded"] or infos[1]["sharded"] != infos[3]["sharded"]:
        raise AssertionError("train dp x tp: a tp shard differs across its dp pair")
    _say("train", "dp 2 x tp 2: the replicated parameters bit-equal on all ranks, each shard on "
                  "its dp pair; losses within 1% of the single card's, step 1's gradients "
                  "within the gates of the single card's")
    del state, grads, ref, dev
    torch.cuda.empty_cache()
    secs = time.perf_counter() - phase_t0
    _say("train", f"phase {secs:.2f} s")
    return {"losses": losses, "launches": launches, "split_ms": split, "backward_share": share,
            "grads": agree, "mesh_grads": mesh_agree, "mesh": infos, "secs": secs,
            "default_rate_losses": rates}


def _pp_rank(rank: int, world: int, job: dict) -> None:
    """One stage of ``[pp]`` (parallel/launch.py): its layers of the parent's
    tree, the encoder on the frames in PP_MICROBATCHES microbatches (launch
    counts, embedding, median ms) to ``rank<r>.*`` in the job's directory."""
    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import median_ms
    from yolo_sam_inference_tpu_torch.models.sam import SamImageEncoder
    from yolo_sam_inference_tpu_torch.parallel.pp import sam_image_encoder_pp
    from yolo_sam_inference_tpu_torch.weights import load_tree

    d = Path(job["dir"])
    cfg = job["cfg"]
    enc = SamImageEncoder(load_tree(d / f"stage{rank}.npz"), cfg).to("cuda", torch.bfloat16)
    pix = torch.from_numpy(np.load(d / "pix.npy")).cuda().to(torch.bfloat16)
    per = cfg.vision_layers // world
    stage = range(rank * per, (rank + 1) * per)
    glob = sum(i in cfg.global_attn_indexes for i in stage)
    m = PP_MICROBATCHES
    expected = {"gemm_bf16": 4 * per * m, "window_attn_relpos": per * m}
    if rank == world - 1:
        expected["layer_norm"] = 2  # the neck, on the last stage
    with torch.inference_mode():
        wrappers = _reset_counts()
        emb = sam_image_encoder_pp(enc, pix, cfg, microbatches=m)
        torch.cuda.synchronize()
        launches = _read_counts(f"pp stage {rank} of {world} (layers {stage.start}-"
                                f"{stage.stop - 1}, {m} microbatches)", wrappers, expected,
                                by_window={16: (per - glob) * m, 32: glob * m})
        ms = median_ms(lambda: sam_image_encoder_pp(enc, pix, cfg, microbatches=m), reps=5,
                       warmup=1)
    np.save(d / f"rank{rank}.npy", emb.float().cpu().numpy())
    with open(d / f"rank{rank}.json", "w") as f:
        json.dump({"launches": launches, "ms": ms}, f)


def _pp_phase(card: str, vit_b_pipe) -> dict:
    """``[pp]``: the pipeline-parallel encoder, ViT-B (config 1's weights as
    the earlier phases left them, the 512 canvas) in PP_RANKS stages of 6
    layers on gloo ranks sharing the card, PP_MICROBATCHES microbatches of
    SLICE_BATCH frames: the stages' embeddings equal, against the single
    card's bf16 kernel encoder (2%) and the fp32 plain encoder (5%)."""
    import tempfile

    import numpy as np
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.models.sam import adapt_resolution
    from yolo_sam_inference_tpu_torch.ops.preprocess import sam_preprocess_batch
    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
    from yolo_sam_inference_tpu_torch.parallel.pp import stage_tree
    from yolo_sam_inference_tpu_torch.weights import save_tree

    phase_t0 = time.perf_counter()
    cfg = _vit_512("vit-b")
    tree = adapt_resolution(vit_b_pipe.sam_params, cfg)
    frames = cell_frames(np.random.default_rng(20), SLICE_BATCH, FRAME)
    pix, _, _ = sam_preprocess_batch(torch.from_numpy(frames).cuda(), FRAME)
    emb16, emb32, ms = _encoders_single(tree, cfg, pix)
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(PP_RANKS):
            save_tree(f"{tmp}/stage{r}.npz", stage_tree(tree, cfg, PP_RANKS, r)["vision"])
        np.save(f"{tmp}/pix.npy", pix.cpu().numpy())
        backend = run_ranks(_pp_rank, PP_RANKS, ({"dir": tmp, "cfg": cfg},))
        embs = [np.load(f"{tmp}/rank{r}.npy") for r in range(PP_RANKS)]
        infos = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(PP_RANKS)]
    if not all(np.array_equal(e, embs[0]) for e in embs[1:]):
        raise AssertionError("pp: the stages' embeddings differ")
    e16, e32 = emb16.cpu().numpy(), emb32.cpu().numpy()
    rel16 = float(np.linalg.norm(embs[0] - e16) / np.linalg.norm(e16))
    rel32 = float(np.linalg.norm(embs[0] - e32) / np.linalg.norm(e32))
    rank_ms = [i["ms"] for i in infos]
    _say("pp", f"ViT-B in {PP_RANKS} stages ({backend}), {PP_MICROBATCHES} microbatches of "
               f"{SLICE_BATCH // PP_MICROBATCHES}: embedding {embs[0].shape} equal on all stages; "
               f"rel_rms vs the single-card bf16 encoder {rel16:.3e} (bound 0.02; max_abs "
               f"{np.abs(embs[0] - e16).max():.3e}), vs the fp32 plain encoder {rel32:.5f} (bound "
               f"0.05); ms by stage {rank_ms}, the single card {ms:.3f} (stages sharing one card: "
               f"no pp speed) [{card}]")
    if not (rel16 <= 0.02 and rel32 <= 0.05 and np.isfinite(embs[0]).all()):
        raise AssertionError("pp: the pipeline-parallel embedding disagrees with the single card")
    torch.cuda.empty_cache()
    secs = time.perf_counter() - phase_t0
    _say("pp", f"phase {secs:.2f} s")
    return {"rel16": rel16, "rel32": rel32, "ms": rank_ms, "single_ms": ms,
            "launches": [i["launches"] for i in infos], "secs": secs}


def _multichip_phase(card: str) -> dict:
    """``[multichip]``: ``parallel.dryrun.dryrun_multichip(MESH_RANKS)`` on gloo
    ranks sharing the card (its module note says what each part checks)."""
    import torch

    from yolo_sam_inference_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(MESH_RANKS)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    _say("multichip", f"dryrun_multichip({MESH_RANKS}) passed in {secs:.2f} s [{card}]")
    return {"secs": secs}


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
    pr = _prompts_phase(card)
    sp = _slice_phase(card)
    ck = _conv_kernel_phase(card)
    fs = _fused_slice_phase(card, sp["pipe"], sp.pop("frames"), sp["ms_per_batch"])
    dr = _directory_phase(card, sp["pipe"])
    cp = _checkpoint_phase(card, sp["launches"])
    sv = _serve_phase(card, sp["pipe"])
    pj = _project_phase(card, sp["pipe"])
    ap = _apps_phase(card, sp["pipe"])
    clp = _classical_phase(card)
    rg = _registry_phase(card, sp["pipe"])
    dpp = _dp_phase(card, sp["pipe"])
    frp = _frames_phase(card)
    bk = _big_kernel_phase(card)
    big = {model.rsplit("-", 1)[-1]: _big_slice_phase(card, model, max_det, layers)
           for model, max_det, layers, *_ in BIG_MODELS}
    lk = _large_kernel_phase(card)
    vit_b_pipe, vit_h_pipe = sp.pop("pipe"), big["huge"].pop("pipe")
    lf = _large_frame_phase(card, vit_b_pipe, vit_h_pipe)
    rk = _relpos_kernel_phase(card)
    og = _offgrid_slice_phase(card, vit_b_pipe)
    sq = _sp_slice_phase(card, "config 4", *lf.pop("sp inputs"))
    sq896 = _sp_slice_phase(card, "896", *og.pop("sp inputs"))
    mk = _mobile_kernel_phase(card)
    ms = _mobile_slice_phase(card)
    tpp = _tp_phase(card, vit_b_pipe, vit_h_pipe)
    tr = _train_phase(card, vit_b_pipe)
    ppp = _pp_phase(card, vit_b_pipe)
    mc = _multichip_phase(card)
    hp = _hiera_attention_phase(card)
    rsp = _resample_phase(card)

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
                        ":231 t2i_shared_attend)", "keys_stream tq7"),
        ("t2i_combine", "ops/decoder_fused.py:298 i2t_keys_update (its next-stage t2i, joined "
                        "over the tiles)", "t2i_combine tq7"),
        ("t2i_attend", "ops/decoder_fused.py:231 t2i_shared_attend", "t2i_attend tq7"),
        ("window_crop", "ops/window_crop.py:46 window_crop", "window_crop"),
        ("hull_support", "ops/hull_support.py:55 support_vertices_tpu (+ the candidates of "
                         "ops/metrics.py:148 _hull_candidate_scores)", "hull_support"),
    ):
        src = "decoder_keys.cu" if name.startswith(("keys", "t2i")) else f"{name}.cu"
        table.append(entry(name, "cuda", f"csrc/{src}", replaces, sp["launches"][name],
                           dp["errs"][name], dt[timed], db[timed], dp["library"].get(timed),
                           dp["device"].get(timed, (None, None))))
    # K8 at config 4's 7 x 7 windows of the 64 x 64 grid
    table.append(entry("window_crop gs64", "cuda", "csrc/window_crop.cu",
                       "ops/window_crop.py:46 window_crop", lf["config 4"]["window_crop"],
                       dp["errs"]["window_crop"], dt["window_crop gs64"], db["window_crop gs64"],
                       None, dp["device"]["window_crop gs64"]))
    # K9 under hull_mode="reference" (config 1 from checkpoint files): the same call
    table.append(entry("hull_support reference", "cuda", "csrc/hull_support.cu",
                       "ops/hull_support.py:55 support_vertices_tpu (hull_mode=\"reference\")",
                       cp["ref_launches"]["hull_support"], dp["errs"]["hull_support"],
                       dt["hull_support"], db["hull_support"], dp["library"].get("hull_support"),
                       dp["device"]["hull_support"]))
    # K9 on the classical path: one launch a batch over its frames' cells
    table.append(entry("hull_support classical", "cuda", "csrc/hull_support.cu",
                       "ops/hull_support.py:55 support_vertices_tpu (classical/pipeline.py's "
                       "metrics)", clp["launches"]["hull_support"], clp["errs"]["hull_support"],
                       clp["k9"]["times"], clp["k9"]["bound"], None, clp["k9"]["device"]))
    # K9's frames' kernels: calculate_metrics on a whole frame (2100 x 2300)
    table.append(entry("hull_support frame", "cuda", "csrc/hull_support.cu",
                       "ops/hull_support.py:55 support_vertices_tpu (ops/metrics.py:535 "
                       "calculate_metrics on a whole frame)", frp["launches"]["hull_support"],
                       frp["errs"]["hull_support"], frp["times"], frp["bound"], None,
                       frp["device"]))
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
    for name, shape, launches in (("conv2d_act", "detect box1 level 0", fs["launches"]),
                                  ("conv2d_act sam neck", "sam neck", fs["launches"]),
                                  ("conv2d_act yolo stem", "yolo stem", fs["launches"]),
                                  ("conv2d_act yolov8s down5", "yolov8s down5",
                                   cp["fused_launches"])):
        table.append(entry(name, "cuda", "csrc/conv2d_act.cu",
                           "ops/conv2d_fused.py:428 conv2d_act (pallas_call :524)",
                           launches["conv2d_act"], ck["errs"]["conv2d_act"], ct[shape],
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
    # the tensor-parallel encoder's row-parallel products (each rank's proj
    # and mlp2, K = C / tp and hidden / tp); the launches are a tp rank's
    # gemm_bf16 launches in [tp] (4 a layer)
    for key, model in (("tp ViT-B K384", "vit-b"), ("tp ViT-H K640", "vit-h")):
        table.append(entry(f"gemm_bf16 {key}", "cuda", "csrc/gemm_bf16.cu",
                           "parallel/tp.py:169, :197 (XLA: the row-parallel projection and "
                           "mlp2 before their psum; no pallas_call)",
                           tpp["launches"][model]["gemm_bf16"], tpp["errs"]["gemm_bf16"],
                           tpp["times"][key], tpp["bounds"][key], tpp["library"][key]))
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
    sj, sb = sv["bench"]["json"], sv["bench"]["bin"]
    _say("result", f"serve at batch {TIMED_BATCH}: {SERVE_REQUESTS} mixed requests at "
                   f"{sv['req_s']:.2f} req/s (fill {sv['stats']['mean_batch_fill']}); the "
                   f"collector's batch alone {TIMED_BATCH / sv['ceiling_ms'] * 1e3:.2f} img/s; "
                   f"bench/serve.py json {sj['value']} img/s (p50 {sj['p50_request_latency_ms']} / "
                   f"p99 {sj['p99_request_latency_ms']} ms, host CPU "
                   f"{sj['host_cpu_ms_per_request']} ms a request), bin {sb['value']} img/s (p50 "
                   f"{sb['p50_request_latency_ms']} / p99 {sb['p99_request_latency_ms']} ms, host "
                   f"CPU {sb['host_cpu_ms_per_request']} ms); project runner {pj['rows']} rows, "
                   f"{pj['gated']} gated, {pj['secs']:.2f} s; frame cleaner {ap['counts']} "
                   f"[{card}]")
    cs_, ss_ = clp["split"], clp["stream_split"]
    _say("result", f"classical project runner {clp['project_fps']:.1f} frames/s (files to CSV, "
                   f"2 thresholds, batch 16, 512x512); a batch of 16: PNG load "
                   f"{cs_['load_ms']:.3f} ms, device morphology "
                   f"{cs_['morphology_ms']:.3f} ms, fetch {cs_['fetch_ms']:.3f}, host label + "
                   f"crop {cs_['label_crop_ms']:.3f}, metrics call {cs_['metrics_ms']:.3f}; "
                   f"stream runner {clp['stream_fps']:.1f} frames/s (256x256, batch 64), cv2 "
                   f"topology {ss_['topology_ms_per_frame']:.4f} ms a frame, device morphology "
                   f"{ss_['morphology_ms']:.3f} ms a batch [{card}]")
    rg_split = json.dumps({k: round(v, 3) for k, v in rg["split_ms"].items()})
    _say("result", f"registry process_pending {rg['fps']:.2f} files/s (one process_batch_arrays a "
                   f"file; a file's ms {rg_split}); dp mesh ms/batch of {TIMED_BATCH} by rank "
                   f"{dpp['ms']}, the sp runner "
                   f"{dpp['sp_runner_s']:.2f} s against {dpp['single_runner_s']:.2f} s on one "
                   f"rank ({DP_RANKS} ranks on one card: no dp speed-up measurable) [{card}]")
    bt_ms, mt_ms = cp["builds"], cp["metric_ms"]
    _say("result", f"config 1 build from checkpoint files (load + convert + adapt + cast + "
                   f"upload) {statistics.median(bt_ms['files']) * 1000:.1f} ms, seeded build "
                   f"{statistics.median(bt_ms['seeded']) * 1000:.1f} ms (medians of the turns) "
                   f"[{card}]")
    _say("result", f"metrics stage at batch {TIMED_BATCH}: hull_mode reference "
                   f"{statistics.median(mt_ms['reference']):.3f} ms, polygon "
                   f"{statistics.median(mt_ms['polygon']):.3f} ms (medians of the turns) [{card}]")
    _say("result", f"tp={TP_RANKS} encoder ms by rank (ranks sharing one card): ViT-B "
                   f"{tpp['vit-b ms']} (single card {tpp['vit-b single ms']:.3f}), ViT-H "
                   f"{tpp['vit-h ms']} (single card {tpp['vit-h single ms']:.3f}); pp={PP_RANKS} "
                   f"ViT-B ms by stage {ppp['ms']} (single card {ppp['single_ms']:.3f}); train "
                   f"step ms " + json.dumps({k: round(v, 3) for k, v in tr["split_ms"].items()})
                   + f" (backward {tr['backward_share']:.3f} of it), losses {tr['losses']}; "
                   f"phases [tp] {tpp['secs']:.1f} s, [train] {tr['secs']:.1f} s, [pp] "
                   f"{ppp['secs']:.1f} s, [multichip] {mc['secs']:.1f} s [{card}]")
    # SAM 2's attention replaces no TPU kernel (the JAX package has no Hiera)
    for case in _hiera_cases():
        row = entry(f"hiera_attention {case}", "cuda", "csrc/hiera_attention.cu", "",
                    hp["launches"][f"hiera_attention {case}"],
                    hp["errs"]["hiera_attention"], hp["times"][case],
                    hp["bounds"][case], hp["library"][case], hp["device"][case])
        row["replaces"] = "none (cuDNN's SDPA and the window copies)"
        table.append(row)
    # the frames' resample replaces no TPU kernel (XLA's jax.image.resize);
    # its launches: the SAM 2 drive's batch of 2048² frames
    for case in rsp["times"]:
        row = entry(f"resample {case}", "cuda", "csrc/resample.cu", "",
                    hp["launches"]["resample"], rsp["errs"][case], rsp["times"][case],
                    rsp["bounds"][case], rsp["library"][case], rsp["device"][case])
        row["replaces"] = "none (the dense fp32 einsum; XLA's jax.image.resize in the JAX package)"
        table.append(row)
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
