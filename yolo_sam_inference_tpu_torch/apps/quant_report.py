"""int8 calibration report: quantify what ``quant="int8"`` does to YOUR data.

The port of the JAX package's ``apps/quant_report.py``. The w8a8 encoder
path (``ops/quant.py``; on the card ``csrc/gemm_int8.cu``) trades exact bf16
numerics for the int8 tensor cores on the SAM encoder's projections. This
tool runs the same images through the exact (bf16) and int8 pipelines —
same weights, same YOLO detections (YOLO is never quantized, so detection
slots align one-to-one) — and reports

* per-detection mask IoU between the two pipelines' SAM masks, and
* per-metric |Δ| (mean / p99 / max) across all 16 morphometrics,

as ``quant_calibration.csv`` + ``quant_calibration_summary.txt`` plus one
JSON line on stdout for scripting. Runs on the card unless asked for the CPU.

Usage::

    python -m yolo_sam_inference_tpu_torch.apps.quant_report \\
        --input-dir data/frames --output-dir out \\
        [--sam-model facebook/sam-vit-large] [--batch-size 32]
        [--max-images 256]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..pipeline.engine import CellSegmentationPipeline, PipelineOptions
from ..utils.logger import setup_logger

logger = setup_logger(__name__)


def compare_outputs(out_f: Dict, out_q: Dict, n_valid: int) -> Dict[str, List[float]]:
    """Per-valid-detection comparison of one batch's float vs int8 outputs
    (pad images beyond ``n_valid`` excluded).

    Returns {"iou": [...], "<metric>": [|Δ| ...]}. Detections align
    slot-for-slot because quantization never touches the YOLO stage; a
    validity mismatch (possible only if a mask empties out entirely) is
    counted under "valid_mismatch".
    """
    rows: Dict[str, List[float]] = {"iou": []}
    vf = out_f["valid"][:n_valid]
    vq = out_q["valid"][:n_valid]
    both = vf & vq
    rows["valid_mismatch"] = [float(x) for x in (vf ^ vq).sum(axis=1)]
    mf, mq = out_f["mask_crops"][:n_valid], out_q["mask_crops"][:n_valid]
    for b, k in zip(*np.nonzero(both)):
        a, c = mf[b, k], mq[b, k]
        union = np.logical_or(a, c).sum()
        inter = np.logical_and(a, c).sum()
        rows["iou"].append(float(inter) / float(union) if union else 1.0)
    for key in out_f["metrics"]:
        d = np.abs(
            out_f["metrics"][key][:n_valid] - out_q["metrics"][key][:n_valid]
        )[both]
        rows.setdefault(key, []).extend(float(x) for x in d)
    return rows


def summarize(acc: Dict[str, List[float]]) -> Dict[str, Dict[str, float]]:
    """{quantity: {mean, p99, max, n}} of the accumulated :func:`compare_outputs`
    lists; a quantity with no value is left out."""
    summary: Dict[str, Dict[str, float]] = {}
    for k, v in acc.items():
        if not v:
            continue
        a = np.asarray(v, dtype=np.float64)
        summary[k] = {
            "mean": float(a.mean()),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max()),
            "n": int(a.size),
        }
    return summary


def run_report(
    pipe_float: CellSegmentationPipeline,
    pipe_int8: CellSegmentationPipeline,
    files: List[Path],
    output_dir: Path,
    batch_size: int,
) -> Dict[str, Dict[str, float]]:
    """Drive both pipelines over ``files`` and write the calibration report.

    Returns {"iou": {...}, "<metric>": {mean, p99, max, n}} (also persisted
    as CSV + summary text under ``output_dir``)."""
    from ..pipeline.loader import batched_image_loader

    output_dir.mkdir(parents=True, exist_ok=True)
    acc: Dict[str, List[float]] = {}
    n_images = 0
    for batch, paths, n_valid, _ in batched_image_loader(files, batch_size):
        out_f = pipe_float.process_batch_arrays(batch)
        out_q = pipe_int8.process_batch_arrays(batch)
        for k, v in compare_outputs(out_f, out_q, n_valid).items():
            acc.setdefault(k, []).extend(v)
        n_images += n_valid
    summary = summarize(acc)

    csv_path = output_dir / "quant_calibration.csv"
    with open(csv_path, "w") as f:
        f.write("quantity,mean,p99,max,n\n")
        for k in sorted(summary):
            s = summary[k]
            f.write(f"{k},{s['mean']:.6g},{s['p99']:.6g},{s['max']:.6g},{s['n']}\n")

    iou = summary.get("iou", {"mean": 1.0, "p99": 1.0, "max": 0.0, "n": 0})
    deform = summary.get("deformability")
    lines = [
        f"int8 calibration report ({n_images} images, "
        f"{iou['n']} matched detections)",
        f"SAM model: {pipe_float.sam_model_type}",
        f"mask IoU (int8 vs bf16): mean {iou['mean']:.4f}, "
        f"worst {min(acc.get('iou', [1.0])):.4f}" if iou["n"] else
        "mask IoU: no detections matched",
    ]
    if deform:
        lines.append(
            f"|Δ deformability|: mean {deform['mean']:.5f}, "
            f"p99 {deform['p99']:.5f}, max {deform['max']:.5f}"
        )
    mism = summary.get("valid_mismatch")
    if mism and mism["max"] > 0:
        lines.append(
            f"WARNING: {int(sum(acc['valid_mismatch']))} detection slot(s) "
            "changed validity under int8"
        )
    text = "\n".join(lines) + "\n"
    (output_dir / "quant_calibration_summary.txt").write_text(text)
    logger.info("%s", text)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--sam-model", default="facebook/sam-vit-base")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-images", type=int, default=256)
    p.add_argument("--max-det", type=int, default=16)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    from ..io.images import list_image_files

    input_dir = Path(args.input_dir)
    if not input_dir.is_dir():
        p.error(f"input directory does not exist: {input_dir}")
    files = list_image_files(input_dir)[: args.max_images]
    if not files:
        p.error(f"no images found under {input_dir}")

    def mk(quant: str) -> CellSegmentationPipeline:  # one seed: the same weights
        return CellSegmentationPipeline(
            sam_model_type=args.sam_model, device=args.device,
            options=PipelineOptions(batch_size=args.batch_size, max_det=args.max_det,
                                    quant=quant))

    summary = run_report(mk("none"), mk("int8"), files, Path(args.output_dir), args.batch_size)
    print(json.dumps({"n": summary.get("iou", {}).get("n", 0),
                      "iou_mean": summary.get("iou", {}).get("mean"),
                      "deformability_max_delta":
                      summary.get("deformability", {}).get("max")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
