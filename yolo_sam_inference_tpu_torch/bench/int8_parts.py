"""Device time of each kernel of the w8a8 functions, from ``torch.profiler``.

    python -m yolo_sam_inference_tpu_torch.bench.int8_parts

At batch-32 shapes (32768 rows): K11c (``ln_quant`` + ``gemm_int8`` QKV) at
ViT-L and ViT-H, K11a's tail at ViT-L and K11b's at ViT-H (``ln_quant``,
``gemm_int8`` MLP1, ``gelu_quant``, ``gemm_int8`` MLP2), each kernel's mean
device time over 10 calls after 20 warm-ups; then ``gemm_int8`` alone at
ViT-H's mlp2 shape (32768 x 5120 @ 5120 x 1280) in its QKV mode (ping-pong
warpgroups) and its MLP2 mode (cooperative warpgroups, an fp32 fold at each
chunk boundary) with 1 and 4 chunks, without the second residual, which
shows what the MLP2 mode's structure and its folds cost. Needs one card.
"""

from __future__ import annotations

import re


def _parts(fn, n: int = 10) -> dict:
    """Mean device ms per call of each kernel that ``fn()`` launches. As in
    ``bench/common.py::device_ms``, the session runs ``n`` calls before and
    after the ``n`` it measures (the profiler may drop a session's last
    records) and keeps the kernels that start inside the measured window; a
    kernel whose count of records there is not a multiple of ``n`` is left
    out, with a line on stderr."""
    import sys

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "int8_parts window"
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    window = [e.time_range for e in events if e.name == mark and e.device_type == DeviceType.CPU]
    totals: dict = {}
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name == mark
                or not window[0].start <= e.time_range.start <= window[0].end):
            continue
        m = re.search(r"(\w+_kernel)(<(\d+)>)?", e.name)
        name = (m.group(1) + (f"<{m.group(3)}>" if m.group(3) else "")) if m else e.name[:40]
        us, count = totals.get(name, (0.0, 0))
        totals[name] = (us + e.time_range.end - e.time_range.start, count + 1)
    parts: dict = {}
    for name, (us, count) in totals.items():
        if count % n:
            print(f"int8_parts {name}: {count} records in a window of {n} calls: not measured",
                  file=sys.stderr, flush=True)
        else:
            parts[name] = us / n / 1e3
    return parts


def main() -> None:
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import card
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
    from yolo_sam_inference_tpu_torch.ops.quant import quantize_weight

    print(card(), flush=True)
    g = torch.Generator().manual_seed(0)

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).cuda()

    def say(label, parts):
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
              + f"; sum {sum(parts.values()):.4f} ms", flush=True)

    m = 32 * 1024
    for tag, c, tiled in (("ViT-L", 1024, False), ("ViT-H", 1280, True)):
        hidden = 4 * c
        x, h = rn(m, c).bfloat16(), rn(m, c).bfloat16()
        s, b = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        wq, ws = quantize_weight(rn(c, 3 * c, std=c ** -0.5))
        (w1q, w1s), (w2q, w2s) = (quantize_weight(rn(c, hidden, std=c ** -0.5)),
                                  quantize_weight(rn(hidden, c, std=hidden ** -0.5)))
        bq, b1, b2 = rn(3 * c, std=0.1), rn(hidden, std=0.1), rn(c, std=0.1)
        say(f"K11c {tag}", _parts(lambda: tln.fused_ln_matmul_int8(x, s, b, wq, ws, bq)))
        tail = tln.fused_ln_mlp_tiled_int8 if tiled else tln.fused_ln_mlp_int8
        say(f"{'K11b' if tiled else 'K11a'} {tag}",
            _parts(lambda: tail(x, h, s, b, w1q, w1s, b1, w2q, w2s, b2)))
        del x, h

    k, n = 5120, 1280
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).cuda()
    wq, ws = quantize_weight(rn(k, n, std=k ** -0.5))
    b, r = rn(n, std=0.1), rn(m, n).bfloat16()
    out = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
    sa = rn(m).abs() + 0.01
    say(f"gemm_int8 QKV mode {m}x{k} @ {k}x{n}",
        _parts(lambda: tln._gemm_int8(tln._QKV, a, sa, wq, ws, b, out)))
    for chunks in (1, 4):
        sc = rn(m, chunks).abs() + 0.01
        say(f"gemm_int8 MLP2 mode, {chunks} chunk(s), one residual",
            _parts(lambda: tln._gemm_int8(tln._MLP2, a, sc, wq, ws, b, out, r1=r,
                                          chunk=k // chunks)))


if __name__ == "__main__":
    main()
