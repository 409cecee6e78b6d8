"""The one traffic generator: gray microscopy-like frames from ``--seed``.

A traffic mix is a JSON file under ``cytobench/traffic/``: the frame side,
the cells drawn in each frame, the batch, the batches in flight and the
engine's per-batch limits (max_det, metric_crop, thresholds, canvases). The
stream cycles a pool of ``pool_batches`` distinct batches, so every seed
sends the same number of frames of the same size, and only where the cells
lie and how bright they are changes.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def cell_frames(rng: np.random.Generator, n: int, size: int, cells: int) -> np.ndarray:
    """uint8 (n, size, size) gray frames: a noisy dark background with
    ``cells`` bright elliptical cells each (radii 10-30 px, centres at least
    40 px from the edge), each drawn inside its bounding box only."""
    frames = np.empty((n, size, size), np.uint8)
    for i in range(n):
        img = rng.normal(40, 5, size=(size, size))
        for _ in range(cells):
            cy, cx = rng.uniform(40, size - 40, size=2)
            ry, rx = rng.uniform(10, 30, size=2)
            y0, x0 = int(cy - ry), int(cx - rx)
            yy, xx = np.mgrid[y0:int(cy + ry) + 2, x0:int(cx + rx) + 2]
            box = img[y0:y0 + yy.shape[0], x0:x0 + yy.shape[1]]
            box[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = rng.uniform(150, 220)
        frames[i] = img.clip(0, 255).astype(np.uint8)
    return frames


def frame_pool(seed: int, traffic: Dict) -> List[np.ndarray]:
    """The ``pool_batches`` batches of (batch, side, side) uint8 frames that
    the stream cycles, drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    return [cell_frames(rng, traffic["batch"], traffic["frame_size"], traffic["cells_per_frame"])
            for _ in range(traffic["pool_batches"])]
