"""Background-subtraction cell detection (the model-free pipeline).

Counterpart of the JAX package's ``classical/pipeline.py``:

* tunable parameters (threshold, dilate / erode iterations, blur kernel and
  sigma, area range, metric crop, batch size);
* each background blurred once on the device and cached there, under the
  caller's key;
* detection: absdiff -> blur -> threshold -> dilate / erode / open on the
  device for the whole batch (``ops/morphology.py``), the masks fetched once
  a batch; connected components on the host (``scipy.ndimage``);
* metrics: ONE ``ops/metrics.py::cell_metrics`` call a batch over every kept
  component of every frame (each cell's frame as ``img_idx``), where the JAX
  package makes one call a frame: the rows are the same, and K9
  (``hull_support``) launches once a batch that has a component; the
  classical placeholders (circularity = deformability = 0.5, area_ratio = 1);
* the ROI intersection filter and the ``pipeline_parameters.json`` snapshot.

Runs on the card (``device="cuda"``, the default) unless asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

try:
    from scipy import ndimage as _ndi
except ImportError:  # pragma: no cover
    _ndi = None

from ..ops.metrics import INT_METRIC_KEYS, METRIC_KEYS, cell_metrics
from ..ops.morphology import classical_detect_batch, gaussian_blur


def resolve_device(device: Union[str, torch.device], who: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): no CUDA device")
    return dev


def gray_frames(frames, device: torch.device) -> torch.Tensor:
    """(B, H, W) gray frames on ``device`` in fp32: uint8 frames go up as
    uint8 (a quarter of the bytes) and are converted there; RGB frames are
    averaged over their channels in fp32 on the host first."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8 or frames.ndim == 4:
        frames = frames.astype(np.float32)
        if frames.ndim == 4:
            frames = frames.mean(axis=3)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device).float()


@dataclasses.dataclass
class ClassicalParams:
    threshold: float = 10.0
    dilate_iterations: int = 2
    erode_iterations: int = 2
    blur_kernel: int = 5
    blur_sigma: float = 0.0
    min_area: float = 50.0
    max_area: float = 1e9
    metric_crop: int = 128
    batch_size: int = 16

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


Component = Tuple[np.ndarray, Tuple[int, int]]  # (crop mask, (row0, col0))


class ClassicalPipeline:
    """Model-free detection against a per-condition background frame."""

    def __init__(self, params: Optional[ClassicalParams] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device, "ClassicalPipeline")
        self.params = params or ClassicalParams()
        self._background_cache: Dict[str, torch.Tensor] = {}

    # -- background ---------------------------------------------------------

    def preprocess_background(self, background: np.ndarray, key: str = "default") -> np.ndarray:
        """Blur a gray (or RGB, averaged on the host) background on the
        device and cache it there under ``key``; returns a host copy."""
        bg = np.asarray(background, dtype=np.float32)
        if bg.ndim == 3:
            bg = bg.mean(axis=2)
        blurred = gaussian_blur(torch.from_numpy(np.ascontiguousarray(bg)).to(self.device),
                                self.params.blur_kernel, self.params.blur_sigma)
        self._background_cache[key] = blurred
        return blurred.cpu().numpy()

    def get_background(self, key: str = "default") -> torch.Tensor:
        """The cached blurred background (on the device)."""
        if key not in self._background_cache:
            raise KeyError(f"background {key!r} not preprocessed")
        return self._background_cache[key]

    # -- detection ----------------------------------------------------------

    def detect_masks_device(self, gray: torch.Tensor, background_key: str = "default"
                            ) -> torch.Tensor:
        """(B, H, W) fp32 frames on the device -> (B, H, W) bool masks there."""
        p = self.params
        return classical_detect_batch(gray, self.get_background(background_key),
                                      threshold=p.threshold, blur_kernel=p.blur_kernel,
                                      blur_sigma=p.blur_sigma,
                                      dilate_iterations=p.dilate_iterations,
                                      erode_iterations=p.erode_iterations)

    def detect_masks_batch(self, frames: np.ndarray, background_key: str = "default"
                           ) -> np.ndarray:
        """(B, H, W) gray (or (B, H, W, 3)) frames -> (B, H, W) bool masks,
        computed on the device and fetched."""
        return self.detect_masks_device(gray_frames(frames, self.device),
                                        background_key).cpu().numpy()

    def extract_components(self, mask: np.ndarray) -> List[Component]:
        """Connected components of one mask -> [(crop_mask, (row0, col0))]:
        host labelling; each kept component (area in [min_area, max_area])
        as a fixed-size crop centred on its bounding box."""
        if _ndi is None:  # pragma: no cover
            raise RuntimeError("scipy required for component labeling")
        labels, _ = _ndi.label(mask)
        out = []
        h, w = mask.shape
        cm = min(self.params.metric_crop, h, w)
        for i, sl in enumerate(_ndi.find_objects(labels), start=1):
            if sl is None:
                continue
            area = int((labels[sl] == i).sum())
            if not (self.params.min_area <= area <= self.params.max_area):
                continue
            cy = (sl[0].start + sl[0].stop) / 2
            cx = (sl[1].start + sl[1].stop) / 2
            r0 = int(np.clip(round(cy) - cm // 2, 0, h - cm))
            c0 = int(np.clip(round(cx) - cm // 2, 0, w - cm))
            out.append((labels[r0:r0 + cm, c0:c0 + cm] == i, (r0, c0)))
        return out

    def batch_metrics(self, comps: List[List[Component]], gray: torch.Tensor
                      ) -> Optional[np.ndarray]:
        """One ``cell_metrics`` call over every component of the batch:
        (N, 16) fp64 rows in ``METRIC_KEYS`` order, frames in turn; None
        when the batch has no component."""
        crops = [c for frame in comps for c, _ in frame]
        if not crops:
            return None
        offs = [o for frame in comps for _, o in frame]
        idx = [b for b, frame in enumerate(comps) for _ in frame]
        dev = gray.device
        mets = cell_metrics(torch.from_numpy(np.stack(crops)).to(dev),
                            gray,
                            torch.tensor(idx, dtype=torch.int64, device=dev),
                            torch.tensor(offs, dtype=torch.int64, device=dev),
                            tuple(gray.shape[1:]))
        return torch.stack([mets[k] for k in METRIC_KEYS], dim=1).cpu().numpy().astype(
            np.float64)

    # -- full image API -----------------------------------------------------

    def process_images(
        self,
        frames: np.ndarray,
        background: Optional[np.ndarray] = None,
        background_key: str = "default",
        roi: Optional[Dict[str, int]] = None,
        return_masks: bool = False,
    ) -> Any:
        """A batch of frames -> per-frame lists of cell-metric dicts.

        Metrics take the classical placeholders (circularity =
        deformability = 0.5, area_ratio = 1); a cell is kept only where its
        bbox meets the ROI. With ``return_masks=True`` also returns the raw
        post-morphology masks and the kept-components-only masks (both
        (B, H, W) bool) for the side-by-side visualizations.
        """
        if background is not None:
            self.preprocess_background(background, background_key)
        gray = gray_frames(frames, self.device)
        masks = self.detect_masks_device(gray, background_key).cpu().numpy()
        comps = [self.extract_components(m) for m in masks]
        table = self.batch_metrics(comps, gray)

        h, w = masks.shape[1:]
        cm = min(self.params.metric_crop, h, w)
        filtered = np.zeros_like(masks, dtype=bool) if return_masks else None
        results: List[List[Dict[str, Any]]] = []
        n = 0
        for b, frame in enumerate(comps):
            rows = []
            for crop, (r0, c0) in frame:
                row = dict(zip(METRIC_KEYS, (float(v) for v in table[n])))
                n += 1
                for key in INT_METRIC_KEYS:
                    row[key] = int(round(row[key]))
                row["circularity"] = 0.5
                row["deformability"] = 0.5
                row["area_ratio"] = 1.0
                if roi is not None and not _bbox_intersects_roi(row, roi):
                    continue
                rows.append(row)
                if filtered is not None:
                    filtered[b, r0:r0 + cm, c0:c0 + cm] |= crop
            results.append(rows)
        if return_masks:
            return results, masks.astype(bool), filtered
        return results

    def save_parameters(self, path) -> None:
        """The ``pipeline_parameters.json`` snapshot."""
        with open(path, "w") as f:
            json.dump(self.to_parameters_dict(), f, indent=2)

    def to_parameters_dict(self) -> Dict[str, Any]:
        return {"pipeline": "classical_background_subtraction", **self.params.to_json()}


def _bbox_intersects_roi(row: Dict[str, Any], roi: Dict[str, int]) -> bool:
    """bbox / ROI intersection in the metric row / col convention: rows
    (min_x) against the ROI's y, cols (min_y) against its x."""
    rows_overlap = row["min_x"] <= roi.get("y_max", 10**9) and row["max_x"] >= roi.get("y_min", 0)
    cols_overlap = row["min_y"] <= roi.get("x_max", 10**9) and row["max_y"] >= roi.get("x_min", 0)
    return rows_overlap and cols_overlap
