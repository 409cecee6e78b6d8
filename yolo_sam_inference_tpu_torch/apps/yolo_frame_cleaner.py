"""Acquisition-frame curator: keep frames with exactly one valid detection.

The port of the JAX package's ``apps/yolo_frame_cleaner.py``: YOLO only,
through the pipeline's ``detect_batch_arrays``, on the card unless asked for
the CPU (``--device``); frames written as PNG without PIL (``io/png.py``).
Capability parity with reference ``tools/yolo_frame_cleaner.py``: run YOLO
per frame, keep detections with conf >= 0.5 (``:262, :285``) whose center is
inside the ROI and whose box is fully contained with a 2px margin
(``is_box_fully_contained :213-231``); a frame passes only with exactly ONE
valid non-boundary detection (``:342``); outputs ``full_frames_with_target/``
and ``cropped_roi_with_target/`` (``:171-183``) plus one ``*_background*``
frame chosen from the no-target pool (``:369-383``); optional recursive walk
(``:385-408``); per-frame color-coded detection debug visualizations
(``:306-339``); YOLO weights from a local path, the MLflow Model Registry,
or an MLflow run artifact (``:486-511``). Batched device inference replaces
the per-frame loop.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def is_box_fully_contained(
    box, roi: Dict[str, int], margin: int = 2
) -> bool:
    """Box fully inside the ROI with a margin (reference ``:213-231``)."""
    x1, y1, x2, y2 = box
    return (
        x1 >= roi["x_min"] + margin
        and y1 >= roi["y_min"] + margin
        and x2 <= roi["x_max"] - margin
        and y2 <= roi["y_max"] - margin
    )


def center_in_roi(box, roi: Dict[str, int]) -> bool:
    cx = (box[0] + box[2]) / 2
    cy = (box[1] + box[3]) / 2
    return roi["x_min"] <= cx <= roi["x_max"] and roi["y_min"] <= cy <= roi["y_max"]


def classify_frame(
    boxes: np.ndarray, scores: np.ndarray, valid: np.ndarray,
    roi: Dict[str, int], conf: float = 0.5,
) -> Tuple[str, Optional[np.ndarray]]:
    """-> ('target', box) | ('background', None) | ('rejected', None).

    target = exactly one confident in-ROI fully-contained detection;
    background = zero confident detections (usable as background frame).
    """
    keep = [
        boxes[i]
        for i in range(len(boxes))
        if valid[i] and scores[i] >= conf and center_in_roi(boxes[i], roi)
    ]
    contained = [b for b in keep if is_box_fully_contained(b, roi)]
    n_any = int(sum(1 for i in range(len(boxes)) if valid[i] and scores[i] >= conf))
    if len(keep) == 1 and len(contained) == 1:
        return "target", contained[0]
    if n_any == 0:
        return "background", None
    return "rejected", None


def _draw_rect(img: np.ndarray, box, color, thickness: int = 2) -> None:
    """In-place rectangle outline (pure numpy; no cv2 dependency)."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(round(float(v))) for v in box)
    x1, x2 = max(0, min(x1, w - 1)), max(0, min(x2, w - 1))
    y1, y2 = max(0, min(y1, h - 1)), max(0, min(y2, h - 1))
    t = thickness
    img[y1:y1 + t, x1:x2 + 1] = color
    img[max(0, y2 - t + 1):y2 + 1, x1:x2 + 1] = color
    img[y1:y2 + 1, x1:x1 + t] = color
    img[y1:y2 + 1, max(0, x2 - t + 1):x2 + 1] = color


def save_debug_visualization(
    image: np.ndarray, boxes: np.ndarray, scores: np.ndarray,
    valid: np.ndarray, roi: Dict[str, int], conf: float, out_path: Path,
) -> None:
    """Color-coded per-frame detection debug image (reference ``:306-339``):
    blue ROI rectangle; green = confident in-ROI fully-contained detection,
    yellow = in-ROI but touching the ROI boundary, red = everything else;
    confidence labels when cv2 is available."""
    from ..io.images import save_image

    if image.ndim == 2:  # loader may deliver collapsed grayscale
        image = np.repeat(image[..., None], 3, axis=-1)
    vis = np.ascontiguousarray(image.copy())
    _draw_rect(vis, (roi["x_min"], roi["y_min"], roi["x_max"], roi["y_max"]),
               (0, 0, 255))
    try:
        import cv2
    except ImportError:
        cv2 = None
    for i in range(len(boxes)):
        if not valid[i]:
            continue
        box = boxes[i]
        ok_conf = scores[i] >= conf
        in_roi = ok_conf and center_in_roi(box, roi)
        if in_roi and is_box_fully_contained(box, roi):
            color = (0, 255, 0)
        elif in_roi:
            color = (255, 255, 0)
        else:
            color = (255, 0, 0)
        _draw_rect(vis, box, color)
        if cv2 is not None:
            cv2.putText(vis, f"{float(scores[i]):.2f}",
                        (int(box[0]), max(0, int(box[1]) - 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 2)
    save_image(out_path, vis)


def clean_frames(
    input_dir: Path,
    output_dir: Path,
    pipeline,
    roi: Optional[Dict[str, int]] = None,
    conf: float = 0.5,
    recursive: bool = False,
    batch_size: int = 16,
    debug_visualizations: bool = True,
) -> Dict[str, int]:
    """Curate a directory of acquisition frames. Returns category counts."""
    from ..io.images import list_image_files, load_image, save_image
    from ..pipeline.loader import batched_image_loader

    input_dir, output_dir = Path(input_dir), Path(output_dir)
    full_dir = output_dir / "full_frames_with_target"
    crop_dir = output_dir / "cropped_roi_with_target"
    full_dir.mkdir(parents=True, exist_ok=True)
    crop_dir.mkdir(parents=True, exist_ok=True)
    if debug_visualizations:  # every frame, like the reference's debug_dir
        debug_dir = output_dir / "debug_visualizations"
        debug_dir.mkdir(parents=True, exist_ok=True)

    files = list_image_files(input_dir, recursive=recursive)
    counts = {"target": 0, "background": 0, "rejected": 0}
    background_pool: List[Path] = []

    for batch, paths, n_valid, _ in batched_image_loader(files, batch_size):
        out = pipeline.detect_batch_arrays(batch)  # YOLO only — no SAM here
        h, w = batch.shape[1:3]
        frame_roi = roi or {"x_min": 0, "y_min": 0, "x_max": w, "y_max": h}
        for i in range(n_valid):
            kind, box = classify_frame(
                out["boxes"][i], out["scores"][i], out["valid"][i], frame_roi, conf
            )
            if debug_visualizations:
                save_debug_visualization(
                    batch[i], out["boxes"][i], out["scores"][i],
                    out["valid"][i], frame_roi, conf,
                    debug_dir / f"debug_{paths[i].stem}_detections.png",
                )
            counts[kind] += 1
            if kind == "target":
                img = batch[i]
                save_image(full_dir / f"{paths[i].stem}.png", img)
                crop = img[
                    frame_roi["y_min"] : frame_roi["y_max"],
                    frame_roi["x_min"] : frame_roi["x_max"],
                ]
                save_image(crop_dir / f"{paths[i].stem}.png", crop)
            elif kind == "background":
                background_pool.append(paths[i])

    if background_pool:
        bg = background_pool[len(background_pool) // 2]
        save_image(full_dir / f"{bg.stem}_background.png", load_image(bg))
        logger.info("Selected background frame: %s", bg.name)
    logger.info("Frame cleaning done: %s", counts)
    return counts


def resolve_model_source(args) -> Optional[str]:
    """YOLO weights source, in the reference's priority order
    (``tools/yolo_frame_cleaner.py:486-511``): Model Registry by name
    (latest version unless pinned), else an MLflow run's
    ``weights/best.pt`` artifact, else the local ``--yolo-model`` path."""
    if args.model_name:
        from ..utils.model_loader import load_model_from_registry

        logger.info("Loading model from MLflow Registry: %s (version: %s)",
                    args.model_name, args.model_version or "latest")
        return load_model_from_registry(
            model_name=args.model_name,
            model_version=args.model_version,
            tracking_uri=args.registry_uri,
            s3_endpoint_url=args.s3_endpoint_url,
            aws_access_key_id=args.aws_access_key_id,
            aws_secret_access_key=args.aws_secret_access_key,
        )
    if args.run_id or args.experiment_id:
        if not (args.run_id and args.experiment_id):
            raise ValueError("both --experiment-id and --run-id must be "
                             "provided when loading from an MLflow run")
        from ..utils.model_loader import load_model_from_mlflow

        logger.info("Loading model from MLflow run: experiment %s, run %s",
                    args.experiment_id, args.run_id)
        return load_model_from_mlflow(args.experiment_id, args.run_id)
    return args.yolo_model


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Curate acquisition frames with YOLO")
    p.add_argument("--input-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--yolo-model", type=str, default=None)
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--roi", type=str, default=None,
                   help="x_min,y_min,x_max,y_max (pixel box; full frame if omitted)")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--no-debug-visualizations", action="store_true",
                   help="skip the per-frame color-coded detection debug images")
    # MLflow model sources (reference tools/yolo_frame_cleaner.py:486-511:
    # registry by name/version, or a run's weights/best.pt artifact)
    p.add_argument("--model-name", type=str, default=None,
                   help="MLflow Model Registry name (latest version if "
                        "--model-version omitted)")
    p.add_argument("--model-version", type=str, default=None)
    p.add_argument("--registry-uri", type=str, default=None)
    p.add_argument("--s3-endpoint-url", type=str, default=None)
    p.add_argument("--aws-access-key-id", type=str, default=None)
    p.add_argument("--aws-secret-access-key", type=str, default=None)
    p.add_argument("--experiment-id", type=str, default=None)
    p.add_argument("--run-id", type=str, default=None)
    args = p.parse_args(argv)
    if not args.input_dir.is_dir():
        print(f"error: --input-dir does not exist: {args.input_dir}")
        return 2

    try:
        yolo_model = resolve_model_source(args)
    except ValueError as e:
        print(f"error: {e}")
        return 2

    roi = None
    if args.roi:
        v = [int(x) for x in args.roi.split(",")]
        roi = {"x_min": v[0], "y_min": v[1], "x_max": v[2], "y_max": v[3]}

    from ..pipeline.engine import CellSegmentationPipeline, PipelineOptions

    pipeline = CellSegmentationPipeline(
        yolo_model_path=yolo_model,
        device=args.device,
        options=PipelineOptions(batch_size=args.batch_size),
    )
    clean_frames(
        args.input_dir, args.output_dir, pipeline, roi,
        conf=args.conf, recursive=args.recursive, batch_size=args.batch_size,
        debug_visualizations=not args.no_debug_visualizations,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
