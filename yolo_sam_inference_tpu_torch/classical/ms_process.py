"""The classical pipeline over ``images.bin`` acquisition streams.

Counterpart of the JAX package's ``classical/ms_process.py``: streams the
binary container in batches without loading all frames, reads ``roi.csv``
(x, y, width, height), prepares the background (denoise, blur, contrast),
and per frame runs blur -> contrast -> saturating subtract -> threshold ->
morphological close / open, then contours with hierarchy and the validity
gates (border touch within 2 px, one inner contour, area in [250, 1200],
the inner / outer area ratio) and the C++-exact metric circularity =
sqrt(4 pi A) / P from the raw contour's moments. Output:
``deformability_results.csv``.

On the card (``device="cuda"``, the default): the blur, contrast, subtract,
threshold, close and open of each batch, and the background's blur and
contrast; the masks are fetched once a batch. On the host, with cv2: the
background's ``fastNlMeansDenoising`` and the contour topology
(``findContours(RETR_TREE)``, ``moments``, ``arcLength``, ``contourArea``,
``boundingRect``), which are sequential. Rows are lists of dicts, and the
CSV is written by ``reporting.write_rows_csv`` with the bytes pandas writes.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..io.images_bin import iter_frame_batches
from ..ops.morphology import (
    contrast,
    gaussian_blur,
    morph_close,
    morph_open,
    subtract_clip,
    threshold_binary,
)
from ..reporting import write_rows_csv
from ..utils.logger import setup_logger
from .pipeline import gray_frames, resolve_device

logger = setup_logger(__name__)

RESULT_COLUMNS = ("frame_index", "area", "perimeter", "circularity", "deformability", "batch")


@dataclasses.dataclass
class MsProcessingConfig:
    """The acquisition program's default configuration."""

    threshold: float = 10.0
    blur_kernel: int = 3
    blur_sigma: float = 0.0
    contrast_alpha: float = 1.2
    contrast_beta: float = 0.0
    close_iterations: int = 1
    open_iterations: int = 1
    min_noise_area: float = 10.0
    border_margin: int = 2
    min_area: float = 250.0
    max_area: float = 1200.0
    min_area_ratio: float = 0.0
    require_single_inner: bool = True
    batch_size: int = 64
    # sampled per-frame stage dumps (original / roi / background / processed
    # PNGs under <batch_dir>/debug): frames {0..4, 10, 20, 50, 100, 500} and
    # every 1000th
    debug_dumps: bool = False

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _need_cv2() -> None:
    if cv2 is None:
        raise RuntimeError("the images.bin pipeline needs cv2 (opencv-python) on the host for "
                           "the background denoise and the contour topology")


def read_roi_csv(path) -> Optional[Dict[str, int]]:
    """roi.csv with columns x, y, width, height (its first row)."""
    path = Path(path)
    if not path.exists():
        return None
    with open(path, newline="") as f:
        row = next(csv.DictReader(f))
    return {k: int(float(row[k])) for k in ("x", "y", "width", "height")}


def crop_roi(frames: np.ndarray, roi: Optional[Dict[str, int]]) -> np.ndarray:
    if roi is None:
        return frames
    return frames[..., roi["y"]:roi["y"] + roi["height"], roi["x"]:roi["x"] + roi["width"]]


def preprocess_background(bg: np.ndarray, cfg: MsProcessingConfig,
                          device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Denoise (host cv2), then blur and contrast on ``device``; the
    prepared background stays there."""
    _need_cv2()
    dev = resolve_device(device, "preprocess_background")
    bg = np.asarray(bg, dtype=np.float32)
    if bg.ndim == 3:
        bg = bg.mean(axis=2)
    bg = cv2.fastNlMeansDenoising(bg.astype(np.uint8)).astype(np.float32)
    out = gaussian_blur(torch.from_numpy(bg).to(dev), cfg.blur_kernel, cfg.blur_sigma)
    return contrast(out, cfg.contrast_alpha, cfg.contrast_beta)


def process_frame_batch_device(frames: torch.Tensor, background: torch.Tensor,
                               cfg: MsProcessingConfig) -> torch.Tensor:
    """(B, H, W) fp32 frames and the prepared background on one device ->
    (B, H, W) bool masks there."""
    blurred = gaussian_blur(frames, cfg.blur_kernel, cfg.blur_sigma)
    enhanced = contrast(blurred, cfg.contrast_alpha, cfg.contrast_beta)
    diff = subtract_clip(enhanced, background[None])
    binary = threshold_binary(diff, cfg.threshold)
    m = morph_close(binary, 3, cfg.close_iterations)
    return morph_open(m, 3, cfg.open_iterations)


def process_frame_batch(frames: np.ndarray, background: torch.Tensor,
                        cfg: MsProcessingConfig) -> np.ndarray:
    """Host frames -> (B, H, W) bool masks, computed on the background's
    device (uint8 frames uploaded as uint8) and fetched once."""
    f = gray_frames(frames, background.device)
    return process_frame_batch_device(f, background, cfg).cpu().numpy()


def contour_metrics(contour: np.ndarray) -> Dict[str, float]:
    """C++-exact: circularity = sqrt(4 pi A) / P from the moments' area and
    the closed arc length."""
    m = cv2.moments(contour)
    area = float(m["m00"])
    perimeter = float(cv2.arcLength(contour, True))
    circ = math.sqrt(4.0 * math.pi * area) / perimeter if perimeter > 0 else 0.0
    return {"area": area, "perimeter": perimeter, "circularity": circ,
            "deformability": 1.0 - circ}


def analyze_mask(mask: np.ndarray, cfg: MsProcessingConfig) -> Optional[Dict[str, float]]:
    """Contour-topology gating of one mask: the metric row of its single
    valid cell, or None where the frame is rejected (no or several
    candidates, border touch, area or ratio out of range)."""
    _need_cv2()
    contours, hierarchy = cv2.findContours(mask.astype(np.uint8), cv2.RETR_TREE,
                                           cv2.CHAIN_APPROX_NONE)
    if not contours:
        return None
    hierarchy = hierarchy[0]  # (N, 4): next, prev, child, parent
    h, w = mask.shape

    outers = [i for i, c in enumerate(contours)
              if hierarchy[i][3] == -1 and cv2.contourArea(c) > cfg.min_noise_area]
    if len(outers) != 1:
        return None
    oi = outers[0]
    outer = contours[oi]

    x, y, bw, bh = cv2.boundingRect(outer)
    if (x <= cfg.border_margin or y <= cfg.border_margin
            or x + bw >= w - cfg.border_margin or y + bh >= h - cfg.border_margin):
        return None

    inners = [i for i, c in enumerate(contours)
              if hierarchy[i][3] == oi and cv2.contourArea(c) > cfg.min_noise_area]
    if cfg.require_single_inner and len(inners) != 1:
        return None

    target = contours[inners[0]] if inners else outer
    mets = contour_metrics(target)
    if not (cfg.min_area <= mets["area"] <= cfg.max_area):
        return None
    if inners:
        outer_area = cv2.contourArea(outer)
        ratio = mets["area"] / outer_area if outer_area > 0 else 0.0
        if ratio < cfg.min_area_ratio:
            return None
        mets["area_ratio"] = ratio
    return mets


def discover_batch_dirs(root: Path) -> List[Path]:
    """Batch dirs are wherever an images.bin lives."""
    return sorted({p.parent for p in Path(root).rglob("images.bin")})


_DEBUG_SAMPLE_INDICES = frozenset({0, 1, 2, 3, 4, 10, 20, 50, 100, 500})


def _is_debug_frame(idx: int) -> bool:
    return idx in _DEBUG_SAMPLE_INDICES or idx % 1000 == 0


def _dump_debug_frames(debug_dir: Path, idx: int, original: np.ndarray, roi_image: np.ndarray,
                       background: np.ndarray, mask: np.ndarray) -> None:
    """PNG stage dumps of one sampled frame (image_{i}_original / _roi /
    _background / _processed), by the port's PNG writer. Never fatal."""
    from ..io.images import save_image

    try:
        debug_dir.mkdir(parents=True, exist_ok=True)
        for stage, img in (("original", original), ("roi", roi_image),
                           ("background", background),
                           ("processed", np.asarray(mask, bool) * 255)):
            save_image(debug_dir / f"image_{idx}_{stage}.png",
                       np.clip(np.asarray(img), 0, 255).astype(np.uint8))
    except Exception as exc:  # pragma: no cover - diagnostics only
        logger.warning("debug dump failed for frame %d: %s", idx, exc)


def process_stream(bin_path: Path, cfg: MsProcessingConfig,
                   background: Optional[np.ndarray] = None,
                   roi: Optional[Dict[str, int]] = None,
                   device: Union[str, torch.device] = "cuda") -> List[Dict[str, Any]]:
    """One images.bin -> rows (frame_index, area, perimeter, circularity,
    deformability[, area_ratio]). Without a background the stream's first
    frame is one (cropped to the ROI once, where the JAX package crops the
    already-cropped frame again and fails on the shapes). With ``cfg.debug_dumps``, sampled frames' stage images land under
    ``<batch_dir>/debug``."""
    _need_cv2()
    dev = resolve_device(device, "process_stream")
    bin_path = Path(bin_path)
    debug_dir = bin_path.parent / "debug"
    rows = []
    frame_idx = 0
    bg_prepped = bg_host = None
    for raw_batch in iter_frame_batches(bin_path, cfg.batch_size):
        batch = crop_roi(raw_batch, roi)
        if bg_prepped is None:
            if background is None:  # the first frame, cropped once with the rest
                background = raw_batch[0]
            bg = crop_roi(background[None], roi)[0] if background.ndim == 2 else background
            bg_prepped = preprocess_background(bg, cfg, dev)
            if cfg.debug_dumps:
                bg_host = bg_prepped.cpu().numpy()
        masks = process_frame_batch(batch, bg_prepped, cfg)
        for i in range(masks.shape[0]):
            if cfg.debug_dumps and _is_debug_frame(frame_idx):
                _dump_debug_frames(debug_dir, frame_idx, raw_batch[i], batch[i], bg_host,
                                   masks[i])
            mets = analyze_mask(masks[i], cfg)
            if mets is not None:
                rows.append({"frame_index": frame_idx, **mets})
            frame_idx += 1
    return rows


def _concat_columns(tables: List[List[Dict[str, Any]]]) -> List[str]:
    """The columns of the batches' frames concatenated as pandas (>= 3)
    concatenates them: each batch's rows' keys in order of first
    appearance, then ``batch``, united in order; a column that some batch
    lacks holds NaN there, so its ints become floats (cast in place)."""
    per_batch = []
    for rows in tables:
        cols = list(dict.fromkeys(k for row in rows for k in row if k != "batch"))
        per_batch.append(cols + ["batch"])
    columns = list(dict.fromkeys(c for cols in per_batch for c in cols))
    for c in columns:
        if any(c not in cols for cols in per_batch):
            for row in (r for rows in tables for r in rows):
                if isinstance(row.get(c), int):
                    row[c] = float(row[c])
    return columns


def process_project(project_dir: Path, output_dir: Path,
                    cfg: Optional[MsProcessingConfig] = None,
                    device: Union[str, torch.device] = "cuda") -> List[Dict[str, Any]]:
    """Every batch dir under a project -> ``deformability_results.csv`` and
    ``pipeline_parameters.json`` in ``output_dir``; returns the rows, each
    with its ``batch``."""
    from ..io.images import load_image

    _need_cv2()
    dev = resolve_device(device, "process_project")
    cfg = cfg or MsProcessingConfig()
    project_dir, output_dir = Path(project_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    tables: List[List[Dict[str, Any]]] = []
    for bdir in discover_batch_dirs(project_dir):
        roi = read_roi_csv(bdir / "roi.csv")
        background = None
        for bg_name in ("background_clean.tiff", "background.tiff", "background.png"):
            if (bdir / bg_name).exists():
                background = load_image(bdir / bg_name, grayscale=True)
                break
        rows = process_stream(bdir / "images.bin", cfg, background, roi, dev)
        for row in rows:
            row["batch"] = bdir.name
        tables.append(rows)
        logger.info("%s: %d valid cells", bdir, len(rows))
    all_rows = [row for rows in tables for row in rows]
    write_rows_csv(all_rows, (), output_dir / "deformability_results.csv",
                   _concat_columns(tables) if tables else RESULT_COLUMNS)
    with open(output_dir / "pipeline_parameters.json", "w") as f:
        json.dump(cfg.to_json(), f, indent=2)
    return all_rows
