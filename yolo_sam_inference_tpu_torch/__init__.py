"""PyTorch + CUDA port of ``yolo_sam_inference_tpu`` for NVIDIA Hopper GPUs.

The layout mirrors the JAX package (``models/yolo``, ``models/sam``, ``ops``,
``pipeline``). The port imports ``torch`` and never ``jax`` nor the JAX
package. Kernels written by hand for the card live in ``csrc/`` (CUDA C++);
each wrapper in ``ops/`` sits beside its plain PyTorch version, which CPU
tensors take.

The root's public names are the JAX package root's; the pipeline classes
import lazily, on first use.
"""

__version__ = "0.1.0"

from .ops.metrics import calculate_metrics
from .utils.image_utils import save_mask_as_tiff, save_optimized_tiff
from .utils.logger import setup_logger
from .utils.mask_encoding import decode_binary_mask, encode_binary_mask
from .utils.metrics_reporter import (
    calculate_summary_statistics,
    report_cell_details,
    report_summary_statistics,
)
from .utils.model_loader import load_model_from_mlflow, load_model_from_registry

_LAZY = {
    "CellSegmentationPipeline": ("yolo_sam_inference_tpu_torch.pipeline.engine",
                                 "CellSegmentationPipeline"),
    "ParallelCellSegmentationPipeline": ("yolo_sam_inference_tpu_torch.pipeline.engine",
                                         "ParallelCellSegmentationPipeline"),
    "ProcessingResult": ("yolo_sam_inference_tpu_torch.pipeline.results", "ProcessingResult"),
    "BatchProcessingResult": ("yolo_sam_inference_tpu_torch.pipeline.results",
                              "BatchProcessingResult"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CellSegmentationPipeline",
    "ParallelCellSegmentationPipeline",
    "ProcessingResult",
    "BatchProcessingResult",
    "setup_logger",
    "load_model_from_mlflow",
    "load_model_from_registry",
    "calculate_summary_statistics",
    "report_summary_statistics",
    "report_cell_details",
    "calculate_metrics",
    "encode_binary_mask",
    "decode_binary_mask",
    "save_optimized_tiff",
    "save_mask_as_tiff",
    "__version__",
]
