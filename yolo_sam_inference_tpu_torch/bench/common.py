"""What the card-side scripts share: the card's name and power limit, CUDA-event
timing, and synthetic cell frames made from a seed."""

from __future__ import annotations

import statistics
import subprocess


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
