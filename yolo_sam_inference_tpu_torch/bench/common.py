"""What the card-side scripts share: the card's name and power limit, CUDA-event
timing, device time from the profiler, and synthetic cell frames made from a
seed."""

from __future__ import annotations

import statistics
import subprocess

# K17's shapes on the paths, timed at batch 32 (chip_smoke.py, kernel_turns.py):
# (name, (H, W, Ci), Co, k, stride, act, bias, channel slice)
CONV_SHAPES = (
    ("yolo stem", (512, 512, 3), 16, 3, 2, "silu", True, False),
    ("c2f3 bottleneck", (64, 64, 32), 32, 3, 1, "silu", True, True),
    ("detect box1 level 0", (64, 64, 64), 64, 3, 1, "silu", True, False),
    ("down5", (32, 32, 128), 256, 3, 2, "silu", True, False),
    ("sam neck", (32, 32, 256), 256, 3, 1, "none", False, False),
    ("tinyvit stem1", (512, 512, 3), 32, 3, 2, "gelu", True, False),
    ("s2d down4 exit k2", (32, 32, 256), 128, 2, 1, "silu", True, False),
)
# K16's depthwise at TinyViT-5M's three block stages on the 512 canvas:
# (stage, grid side, C)
DW_STAGES = ((1, 64, 128), (2, 32, 160), (3, 32, 320))
# K13's window blocks at TinyViT-5M's three stages on the 512 canvas:
# (stage, grid side, C, heads, window)
TINYVIT_STAGES = ((1, 64, 128, 4, 7), (2, 32, 160, 5, 14), (3, 32, 320, 10, 7))
# K15's stride-2 merges on the 512 canvas: (name, input (H, W, C), E, Co)
MERGE_SHAPES = (("merge0", (128, 128, 64), 128, 128), ("merge1", (64, 64, 128), 160, 160))


def card() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, one pair of CUDA events per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, name: str, reps: int = 20):
    """Mean device time in ms of the kernels whose name holds ``name`` in one
    call of ``fn()``, from ``torch.profiler`` (CUPTI); None where the
    profiler recorded none. Unlike :func:`median_ms` it leaves out the host
    time of a short call.

    The profiler may return no record for the last kernels of a session (on
    an H100, a session of one call often returned none, and late in
    ``chip_smoke.py`` a session of 20 calls 0-8 of 20), so one session runs ``reps``
    calls before and after the ``reps`` it measures, and keeps the kernels
    that start inside the measured window (a ``record_function`` range). A
    window whose count of records is not a multiple of ``reps`` is not
    taken (None), and a line on stderr says so."""
    import sys

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    mark = "device_ms window"  # a range on the CPU's timeline, and an annotation on the card's
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        with record_function(mark):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    window = [e.time_range for e in events if e.name == mark and e.device_type == DeviceType.CPU]
    if not window:
        return None
    us = [e.time_range.end - e.time_range.start for e in events
          if e.device_type == DeviceType.CUDA and name in e.name and e.name != mark
          and window[0].start <= e.time_range.start <= window[0].end]
    if not us or len(us) % reps:
        print(f"device_ms {name!r}: {len(us)} kernel records in a window of {reps} calls: "
              f"not measured", file=sys.stderr, flush=True)
        return None
    return sum(us) / reps / 1e3


def cell_frames(rng, n: int, size: int, cells: int = 12):
    """uint8 (n, size, size, 3) gray frames with ``cells`` bright elliptical
    cells each. Each cell is drawn inside its bounding box only."""
    import numpy as np

    frames = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        img = rng.normal(40, 5, size=(size, size))
        for _ in range(cells):
            cy, cx = rng.uniform(40, size - 40, size=2)
            ry, rx = rng.uniform(10, 30, size=2)
            y0, x0 = int(cy - ry), int(cx - rx)
            yy, xx = np.mgrid[y0:int(cy + ry) + 2, x0:int(cx + rx) + 2]
            box = img[y0:y0 + yy.shape[0], x0:x0 + yy.shape[1]]
            box[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = rng.uniform(150, 220)
        frames[i] = img.clip(0, 255).astype(np.uint8)[..., None]
    return frames
