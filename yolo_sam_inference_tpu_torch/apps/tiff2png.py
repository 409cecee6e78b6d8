"""TIFF -> PNG conversion tool on the port.

Parity with the JAX package's ``apps/tiff2png.py``: filename sanitization,
recursive discovery, a structure-preserving output tree, progress logging.
The TIFFs are read by the port's codec (``io/tiff.py``, through
``io/images.load_image``: RGB uint8) and the PNGs written by its writer
(``io/png.py``), with no PIL.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def sanitize_filename(name: str) -> str:
    """Replace anything outside [A-Za-z0-9._-] and collapse repeats."""
    name = re.sub(r"[^A-Za-z0-9._-]+", "_", name)
    name = re.sub(r"_+", "_", name).strip("._")
    return name or "unnamed"


def find_tiffs(root: Path, recursive: bool = True):
    pattern = "**/*" if recursive else "*"
    return sorted(
        p for p in root.glob(pattern)
        if p.is_file() and p.suffix.lower() in (".tif", ".tiff")
    )


def convert_tree(input_dir: Path, output_dir: Path, recursive: bool = True) -> int:
    from ..io.images import load_image, save_image

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    files = find_tiffs(input_dir, recursive)
    n_ok = 0
    for i, src in enumerate(files):
        rel = src.relative_to(input_dir)
        out = output_dir / rel.parent / (sanitize_filename(rel.stem) + ".png")
        out.parent.mkdir(parents=True, exist_ok=True)
        try:
            save_image(out, load_image(src))
            n_ok += 1
        except (OSError, ValueError) as e:
            logger.warning("Failed to convert %s: %s", src, e)
        if (i + 1) % 100 == 0:
            logger.info("converted %d/%d", i + 1, len(files))
    logger.info("Converted %d/%d TIFFs into %s", n_ok, len(files), output_dir)
    return n_ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Convert TIFF images to PNG")
    p.add_argument("--input-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--no-recursive", action="store_true")
    args = p.parse_args(argv)
    if not args.input_dir.is_dir():
        print(f"error: --input-dir does not exist: {args.input_dir}")
        return 2
    convert_tree(args.input_dir, args.output_dir, recursive=not args.no_recursive)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
