"""Device time by kernel over a slice of the pipeline, from ``torch.profiler``.

    python -m yolo_sam_inference_tpu_torch.bench.profile_slice [--batch 32] [--iters 2]
        [--model facebook/sam-vit-base] [--quant none|int8] [--max-det 16] [--cells 12]
        [--frame 512] [--encoder-size N] [--conv2d-fused] [--mbconv-compute fp32|bf16]

Runs ``process_batch_arrays`` (YOLOv8n + the SAM model, ``--frame``-pixel
square frames with ``--cells`` cells each, bf16 or w8a8 int8 encoder;
``--model mobile-sam`` is config 2, ``--model facebook/sam-vit-huge --frame
2048`` config 4, ``--frame 640 --encoder-size 640`` the off-grid cell (the
flat encoder route), ``--conv2d-fused`` the dense convs on K17, ``--mbconv-compute
bf16`` MobileSAM's MBConv and merge kernels in their bf16 mode; random weights from seed
0) twice to warm up, then ``--iters`` batches under the profiler. The
defaults are config 1. Prints, all from that one profiled window: its wall
time, the union of device-kernel intervals (kernel time), the idle share
(1 - kernel time / wall time; the profiler's own host cost inflates it), and
kernel time by category and by kernel name. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import time

CATEGORIES = (  # (substring of the kernel name, category); first match wins
    ("gemm_bf16_kernel", "gemm_bf16"), ("ln_rows_kernel", "gemm_bf16 LN pass"),
    ("gemm_int8_kernel", "gemm_int8"), ("ln_quant_kernel", "int8 LN + row quantisation"),
    ("quant_chunks_kernel", "int8 hidden requantisation"),
    ("window_attn_relpos_kernel", "window_attn_relpos"),
    ("flash_attn_relpos_kernel", "flash_attention_relpos (K12)"),
    ("layer_norm_kernel", "layer_norm (K5, K11d)"),
    ("keys_stream_kernel", "keys_stream"),
    ("tinyvit_attn_kernel", "tinyvit_attn"), ("mbconv_kernel", "mbconv / patch merge"),
    ("dw3x3_ln_kernel", "dw_conv3x3 (+ LN)"), ("conv2d_act", "conv2d_act (K17)"),
    ("t2i_attend_kernel", "t2i_attend"), ("t2i_combine_kernel", "t2i_combine"),
    ("window_crop_kernel", "window_crop"),
    ("hull_support_kernel", "hull_support"), ("memcpy", "memcpy host<->device"),
    ("conv", "cuDNN convolutions"), ("xmma", "cuDNN convolutions"), ("cudnn", "cuDNN convolutions"),
    ("implicit", "cuDNN convolutions"), ("gemm", "library GEMM / bmm"), ("nvjet", "library GEMM / bmm"),
    ("cutlass", "library GEMM / bmm"), ("reduce", "reductions, sort, top-k"),
    ("sort", "reductions, sort, top-k"), ("topk", "reductions, sort, top-k"),
    ("scan", "reductions, sort, top-k"),
)


def category(name: str) -> str:
    low = name.lower()
    for key, cat in CATEGORIES:
        if key in low:
            return cat
    return "elementwise / copy"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--model", default="facebook/sam-vit-base")
    ap.add_argument("--quant", default="none", choices=("none", "int8"))
    ap.add_argument("--max-det", type=int, default=16)
    ap.add_argument("--cells", type=int, default=12)
    ap.add_argument("--frame", type=int, default=512)
    ap.add_argument("--encoder-size", type=int, default=None,
                    help="PipelineOptions.sam_encoder_size (default: the native canvas)")
    ap.add_argument("--conv2d-fused", action="store_true",
                    help="PipelineOptions.conv2d_fused (the dense convs on conv2d_act)")
    ap.add_argument("--mbconv-compute", default="fp32", choices=("fp32", "bf16"),
                    help="PipelineOptions.tinyvit_mbconv_compute (MobileSAM)")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yolo_sam_inference_tpu_torch.bench.common import card, cell_frames
    from yolo_sam_inference_tpu_torch.pipeline.engine import (
        CellSegmentationPipeline,
        PipelineOptions,
    )

    print(card(), flush=True)
    print(f"{args.model}, quant {args.quant}, max_det {args.max_det}, {args.frame}x{args.frame} "
          f"frames with {args.cells} cells, encoder canvas {args.encoder_size or 'native'}, "
          f"conv2d_fused {args.conv2d_fused}, mbconv compute {args.mbconv_compute}", flush=True)
    opts = PipelineOptions(max_det=args.max_det, metric_crop=128, quant=args.quant,
                           sam_encoder_size=args.encoder_size, conv2d_fused=args.conv2d_fused,
                           tinyvit_mbconv_compute=args.mbconv_compute)
    pipe = CellSegmentationPipeline(sam_model_type=args.model, device="cuda", options=opts, seed=0)
    frames = cell_frames(np.random.default_rng(0), args.batch, args.frame, cells=args.cells)
    for _ in range(2):
        pipe.process_batch_arrays(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            pipe.process_batch_arrays(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise SystemExit("the profiler recorded no device kernels")
    busy_us, cur = 0.0, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kern):
        if cur is None or s > cur[1]:
            busy_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += cur[1] - cur[0]
    it = args.iters
    print(f"profiled window: {it} batches of {args.batch}, wall {wall_ms / it:.3f} ms per batch, "
          f"{len(kern) / it:.0f} device kernels per batch, kernel time {busy_us / 1e3 / it:.3f} ms "
          f"per batch, idle share {1 - busy_us / 1e3 / wall_ms:.4f}")
    cats, names = {}, {}
    for k in kern:
        d = k.time_range.end - k.time_range.start
        c = category(k.name)
        cats[c] = cats.get(c, 0.0) + d
        t, n = names.get(k.name, (0.0, 0))
        names[k.name] = (t + d, n + 1)
    total = sum(cats.values())
    print("kernel time by category (ms per batch, share, launches per batch):")
    counts = {}
    for k in kern:
        counts[category(k.name)] = counts.get(category(k.name), 0) + 1
    for c, v in sorted(cats.items(), key=lambda x: -x[1]):
        print(f"  {c}: {v / 1e3 / it:.3f} ms ({v / total * 100:.1f}%), {counts[c] / it:.0f}")
    print("top 25 kernels (ms per batch, launches per batch):")
    for name, (d, n) in sorted(names.items(), key=lambda x: -x[1][0])[:25]:
        print(f"  {d / 1e3 / it:9.3f} ms x{n / it:6.0f} {name[:110]}")


if __name__ == "__main__":
    main()
