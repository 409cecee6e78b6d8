"""What the card-side scripts share: the card's name and power limit, CUDA-event
timing, device time from the profiler, synthetic cell frames made from a
seed, and a PNG writer that needs no PIL."""

from __future__ import annotations

import statistics
import struct
import subprocess
import zlib

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


_PNG_COLOUR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type (gray, RGB, RGBA)


def _png_filter(rows, bpp: int, kind: int):
    """PNG scanline filter ``kind`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of uint8 rows (H, W * bpp): the filtered bytes, each predicted from the
    unfiltered neighbours a (left), b (up), c (up-left), zero off the edge."""
    import numpy as np

    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    elif kind == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type {kind} is not one of 0-4")
    return ((x - pred) % 256).astype(np.uint8)


def png_bytes(image, filter_type: int = 0, level: int = 6) -> bytes:
    """An 8-bit PNG of uint8 ``image``, (H, W) gray or (H, W, 3 | 4) RGB(A),
    not interlaced, every scanline filtered with ``filter_type`` (0-4),
    compressed with zlib."""
    import numpy as np

    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = _png_filter(img.reshape(h, w * ch), ch, filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOUR_TYPES[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path, image, filter_type: int = 0) -> None:
    """Write ``image`` as a PNG file (:func:`png_bytes`)."""
    with open(path, "wb") as f:
        f.write(png_bytes(image, filter_type))
