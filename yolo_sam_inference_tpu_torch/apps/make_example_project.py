"""Generate a synthetic example project on the port (the repository carries
no binary data).

The JAX package's ``apps/make_example_project.py``: the layout ``project/ ->
condition_{a,b}/ -> batch_N/ -> imgs`` with bright elliptical "cells" on a
noisy background, the same pixels from the same seed, written as PNG by the
port's writer (``io/png.py``) with no PIL.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def make_cell_image(rng, h=348, w=704, n_cells=4):
    img = rng.normal(40, 5, size=(h, w)).clip(0, 255)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(n_cells):
        cy = rng.uniform(20, h - 20)
        cx = rng.uniform(20, w - 20)
        ry = rng.uniform(6, 14)
        rx = rng.uniform(6, 14)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img[blob] = rng.uniform(150, 220)
    return np.repeat(img[..., None], 3, axis=2).astype(np.uint8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate a synthetic example project")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--conditions", type=int, default=2)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--images-per-batch", type=int, default=5)
    p.add_argument("--height", type=int, default=348)
    p.add_argument("--width", type=int, default=704)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..io.images import save_image

    rng = np.random.default_rng(args.seed)
    for c in range(args.conditions):
        cond = f"condition_{chr(ord('a') + c)}"
        for b in range(1, args.batches + 1):
            d = args.output_dir / cond / f"batch_{b}"
            d.mkdir(parents=True, exist_ok=True)
            for i in range(args.images_per_batch):
                img = make_cell_image(rng, args.height, args.width)
                save_image(d / f"img_{i:04d}.png", img)
    n = args.conditions * args.batches * args.images_per_batch
    print(f"wrote {n} images under {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
