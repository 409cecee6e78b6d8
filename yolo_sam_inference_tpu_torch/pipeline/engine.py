"""The batch pipeline engine: YOLO detect -> SAM segment -> metrics.

Counterpart of ``yolo_sam_inference_tpu/pipeline/engine.py``. One image
batch runs as four stages on the pipeline's device:

* :func:`detect_stage`: letterbox -> YOLOv8 -> DFL decode -> fixed-shape NMS,
  boxes mapped back to frame pixels;
* :func:`embed_stage`: SAM preprocess -> the model's encoder once per image
  (``encode``: the ViT at the frame's native resolution, MobileSAM's
  TinyViT-5M, or SAM 2.1's Hiera encoder and FPN neck); with
  ``PipelineOptions.encoder_parallel="sp"`` the ViT encoder's token rows are
  split over the ranks of a process group (``parallel/sp.py``), with
  ``"tp"`` its heads and MLP hidden (``parallel/tp.py``: each rank keeps its
  shard of the encoder), and every rank runs the other stages on the whole
  batch and returns the same outputs;
* :func:`segment_stage`: each prompt's crop and the window of the token grid
  that covers it (``ops/window_crop.py``), then the model's
  ``segment_windows``: box prompts -> two-way decoder -> mask logits on the
  window -> bilinear resample onto the crop (SAM 2 also chooses a token);
* :func:`metrics_stage`: the 16 morphometrics per cell.

The SAM family is the configuration's class (``models/sam/config.py``): the
engine names none.

With ``mesh=`` (``parallel/mesh.py``, a data axis of dp ranks) the engine
runs data-parallel: every rank is called with the same frames, runs its
contiguous share of the batch (padded to a multiple of dp) through the four
stages on its own card, and the outputs are gathered over the data axis on
the host, so every rank returns the whole batch's. Beside the data axis an
'sp' or 'tp' axis (dp x sp, dp x tp) holds each dp member's encoder group:
the ranks of one group run the encoder together on their member's share.

Above the stages: ``process_batch_arrays`` (stages synchronised and timed),
``fused_call`` / ``fused_call_chunked`` (device tensors, no sync), and the
directory path (``process_single_image``, ``process_directory``) that
overlaps host decode, device work and the fetch of earlier batches. Frames
go up from pinned host buffers and come back through one pinned fp32 row
pack (``_pack_csv_outputs``) and, where masks are asked for, a device-side
bitpack of the crops (:func:`pack_bits`, 1 bit a pixel).

Weights come from checkpoint files (``models/yolo/convert.py``,
``models/sam/convert.py``) or are random (the JAX package's numpy init, so
one seed gives the same weights in both). Parameters are cast
to ``compute_dtype`` once, when a stage set is built, not per call; with
``quant="int8"`` the encoder's qkv and MLP weights are then quantised (w8a8,
``ops/quant.py``) from the cast weights, as the JAX engine orders it. The
stages' constants (the letterbox's shift and limits, the resample's bands,
SAM's mean and std, the metrics' fill values, the bitpack's weights) are made
on the device at their first use and kept (``ops/constants.py``), so a warm
dispatch copies nothing from the host but the frames and never blocks on it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
import uuid
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.sam import (
    SamTPUConfig,
    mobile_sam,
    sam2_1_hiera_l,
    sam_vit_b,
    sam_vit_h,
    sam_vit_l,
)
from ..models.yolo import (
    YoloConfig,
    decode_predictions,
    init_yolo_params,
    load_yolo_params,
    yolov8n,
)
from ..io.images import list_image_files, load_image
from ..ops.constants import constant
from ..ops.mbconv_fused import COMPUTE_MODES
from ..ops.metrics import HULL_MODES, INT_METRIC_KEYS, METRIC_KEYS, cell_metrics
from ..ops.nms import batched_nms
from ..ops.preprocess import letterbox_batch, sam_preprocess_batch
from ..ops.quant import quantize_sam_encoder_params
from ..ops.window_crop import crop_windows
from ..parallel.mesh import data_shard
from ..parallel.sp import sam_image_encoder_sp
from ..parallel.tp import sam_image_encoder_tp, shard_sam_encoder_tp
from ..weights import from_jax_params
from ..utils.logger import setup_logger
from ..utils.spans import next_batch, span
from .results import (
    BatchProcessingResult,
    ProcessingResult,
    collect_metrics_data,
    collect_timing_data,
    initialize_timing_dict,
    update_total_timing,
)

logger = setup_logger(__name__)

SAM_CONFIGS = {
    "facebook/sam-vit-base": sam_vit_b,
    "facebook/sam-vit-large": sam_vit_l,
    "facebook/sam-vit-huge": sam_vit_h,
    "vit-base": sam_vit_b,
    "vit-large": sam_vit_l,
    "vit-huge": sam_vit_h,
    # MobileSAM: the TinyViT-5M encoder with SAM ViT-B's prompt encoder and decoder
    "mobile-sam": mobile_sam,
    "tinyvit": mobile_sam,
    # SAM 2.1: the Hiera-L encoder and SAM 2's decoder (models/sam/hiera.py)
    "facebook/sam2.1-hiera-large": sam2_1_hiera_l,
}
QUANT_MODES = ("none", "int8")
ENCODER_PARALLEL = ("none", "sp", "tp")
# each stage's key in ``process_batch_arrays``' timings (the reference's)
_TIMING_KEYS = {"detect": "yolo_detection", "embed": "sam_preprocess",
                "segment": "sam_inference_total", "metrics": "metrics_total"}


@dataclass(frozen=True)
class PipelineOptions:
    """Static engine knobs (everything that shapes the computation)."""

    batch_size: int = 8
    max_det: int = 24
    metric_crop: int = 128
    conf_threshold: float = 0.25
    iou_threshold: float = 0.7
    nms_candidates: int = 256
    # YOLO letterbox canvas: None = native (max(H, W) rounded up to a
    # multiple of 32, capped at 640)
    yolo_size: Optional[int] = None
    num_hull_directions: int = 256
    # "polygon" = the exact hull polygon's measures; "reference" = the
    # reference's rasterise-and-remeasure procedure (ops/metrics.py
    # rasterized_hull_measures: deformability about +0.03)
    hull_mode: str = "polygon"
    compute_dtype: torch.dtype = torch.bfloat16
    # SAM encoder canvas: None = the family's own (the ViT's native resolution,
    # the smallest of 256/512/768/1024 that fits the frame; SAM 2's canvas);
    # weights are adapted at stage build time
    sam_encoder_size: Optional[int] = None
    # "int8" = dynamic w8a8 quantisation of the SAM encoder's qkv/MLP
    # projections (ops/quant.py); "none" keeps compute_dtype throughout
    quant: str = "none"
    # "sp" = the ViT encoder's token rows split over the ranks of the
    # pipeline's process group or its mesh's 'sp' axis (parallel/sp.py);
    # "tp" = its heads and MLP hidden over the group or the 'tp' axis
    # (parallel/tp.py)
    encoder_parallel: str = "none"
    # True = every dense (k > 1) conv of YOLOv8, the SAM neck and TinyViT's
    # stems and neck on conv2d_act (K17; the JAX package's CONV2D_FUSED=1),
    # YOLO's 1x1s as its matmul; False keeps F.conv2d
    conv2d_fused: bool = False
    # MobileSAM: "bf16" runs the MBConv and merge kernels' GELUs and depthwise
    # (K14, K15) in bf16 instead of fp32 (ops/mbconv_fused.py), where the
    # JAX package's fused path would
    tinyvit_mbconv_compute: str = "fp32"

    def yolo_size_for(self, h: int, w: int) -> int:
        if self.yolo_size is not None:
            return self.yolo_size
        return min(640, ((max(h, w) + 31) // 32) * 32)


# ------------------------------------------------------------ stage functions


def _ensure_rgb(images_u8: torch.Tensor) -> torch.Tensor:
    """Accept (B, H, W) grayscale or (B, H, W, 3) RGB batches."""
    if images_u8.ndim == 3:
        return images_u8[..., None].expand(*images_u8.shape, 3)
    return images_u8


def _round_floating(tree, dtype: torch.dtype):
    """The tree with its float leaves rounded to ``dtype``, kept as fp32 numpy
    (numpy has no bf16): the values the module cast will hold, so weight
    scales taken from them are the JAX engine's (cast, then quantise)."""
    if isinstance(tree, dict):
        return {k: _round_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_round_floating(v, dtype) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "f" and dtype != torch.float32:
        return torch.from_numpy(np.asarray(tree, np.float32)).to(dtype).float().numpy()
    return tree


def _gray_f32(images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, 3]) uint8 -> (B, H, W) fp32 channel-mean brightness."""
    if images_u8.ndim == 3:
        return images_u8.float()
    return images_u8.float().mean(dim=-1)


def detect_stage(yolo, images_u8: torch.Tensor, ycfg: YoloConfig, opts: PipelineOptions):
    """uint8 (B, H, W[, 3]) -> boxes xyxy in frame pixels (B, K, 4), scores, valid."""
    images_u8 = _ensure_rgb(images_u8)
    h, w = images_u8.shape[1], images_u8.shape[2]
    lb, scale, (pad_x, pad_y) = letterbox_batch(images_u8, opts.yolo_size_for(h, w))
    outs = yolo(lb.to(opts.compute_dtype))
    boxes, scores = decode_predictions(outs, ycfg)
    boxes, scores, valid = batched_nms(
        boxes,
        scores.amax(dim=-1),  # single-class cell detector
        max_det=opts.max_det,
        iou_threshold=opts.iou_threshold,
        conf_threshold=opts.conf_threshold,
        num_candidates=opts.nms_candidates,
    )
    dev = boxes.device
    shift = constant((pad_x, pad_y, pad_x, pad_y), boxes.dtype, dev)
    lim = constant((w - 1, h - 1, w - 1, h - 1), boxes.dtype, dev)
    boxes = torch.minimum(((boxes - shift) / scale).clamp(min=0.0), lim)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return boxes, scores, valid


def embed_stage(sam, images_u8: torch.Tensor, scfg: SamTPUConfig, opts: PipelineOptions,
                group=None, mark=span):
    """uint8 (B, H, W[, 3]) -> the features the segment stage takes: the
    model's ``encode`` of the frames resized to the canvas ``scfg.image_size``
    and normalised (``mark`` makes its spans); for the ViT and TinyViT the
    embeddings (B, gs, gs, C) fp32. With a process ``group``, the ViT encoder
    runs over its ranks as ``opts.encoder_parallel`` says: sequence-parallel,
    or tensor-parallel (``sam.vision`` then holds the rank's shard)."""
    pix, _, _ = sam_preprocess_batch(_ensure_rgb(images_u8), scfg.image_size)
    pix = pix.to(opts.compute_dtype)
    if group is None:
        return sam.encode(pix, mark)
    if opts.encoder_parallel == "tp":
        return sam_image_encoder_tp(sam.vision, pix, scfg, group).float()
    return sam_image_encoder_sp(sam.vision, pix, scfg, group).float()


def segment_stage(sam, feats, boxes: torch.Tensor, valid: torch.Tensor,
                  image_hw: Tuple[int, int], scfg: SamTPUConfig, opts: PipelineOptions,
                  mark=span):
    """Features + boxes -> (mask_crops (B, K, cm, cm) bool, offsets (B, K,
    2)), and each slot's chosen token (B, K; -1 where invalid) where the
    model chooses one (SAM 2). The model's ``segment_windows`` gives each
    prompt's logits on its crop; ``mark`` makes its spans."""
    h, w = image_hw
    b, k = boxes.shape[0], boxes.shape[1]
    cm = min(opts.metric_crop, h, w)
    sam_scale = scfg.image_size / max(h, w)
    windows = crop_windows(boxes, image_hw, cm, scfg.grid_size,
                           sam_scale / (scfg.image_size / scfg.low_res_size))
    crops, token = sam.segment_windows(feats, boxes * sam_scale, windows, mark)
    mask_crops = (crops.reshape(b, k, cm, cm) > 0.0) & valid[..., None, None]
    if token is None:
        return mask_crops, windows.offsets
    return mask_crops, windows.offsets, torch.where(valid, token.reshape(b, k), -1)


def metrics_stage(
    mask_crops: torch.Tensor,
    offsets: torch.Tensor,
    gray: torch.Tensor,
    image_hw: Tuple[int, int],
    opts: PipelineOptions,
) -> Dict[str, torch.Tensor]:
    """(B, K, cm, cm) crops -> dict of (B, K) metric arrays."""
    b, k, cm, _ = mask_crops.shape
    img_idx = torch.arange(b, device=mask_crops.device).repeat_interleave(k)
    mets = cell_metrics(
        mask_crops.reshape(b * k, cm, cm), gray, img_idx, offsets.reshape(b * k, 2),
        image_hw, opts.num_hull_directions, opts.hull_mode,
    )
    return {key: v.reshape(b, k) for key, v in mets.items()}


# the key of each slot's chosen token (SAM 2) in a batch's outputs: beside the
# metrics on the device, its own array (int32) once fetched
MASK_TOKEN = "mask_token"


def _pack_csv_outputs(boxes, scores, valid, offs, mets, token=None) -> torch.Tensor:
    """Every CSV-needed per-detection output as one fp32 (B, K, 8 + M [+ 1])
    tensor: [boxes(4), scores(1), valid(1), offsets(2), metrics(M) in
    sorted-key order, the chosen token where there is one], so one device ->
    host copy covers the row set. All fields are exact in fp32 (coordinates
    < 2^24)."""
    parts = [boxes.float(), scores.float()[..., None], valid.float()[..., None], offs.float()]
    parts += [mets[key].float()[..., None] for key in sorted(mets)]
    if token is not None:
        parts.append(token.float()[..., None])
    return torch.cat(parts, dim=-1)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits(crops: torch.Tensor) -> torch.Tensor:
    """``np.packbits(crops, axis=-1)`` on the tensor's device: bool (..., cm)
    -> uint8 (..., ceil(cm / 8)), the first element of each group of 8 in
    the high bit, the last group zero-padded. Crops cross to the host at 1
    bit a pixel (the JAX engine's ``"pack"``, ``jnp.packbits``)."""
    cm = crops.shape[-1]
    x = torch.nn.functional.pad(crops.to(torch.uint8), (0, (-cm) % 8))
    x = x.reshape(*x.shape[:-1], -1, 8)
    w = constant(_BIT_WEIGHTS, torch.uint8, crops.device)
    return (x * w).sum(dim=-1, dtype=torch.uint8)


class _Slot:
    """Host buffers of one batch in flight: the staged frames and the fetched
    row pack and bitpack. Pinned (page-locked) on a CUDA pipeline, so both
    copies run asynchronously; a slot is reused, not reallocated, once its
    last copies have completed (``done``) and its outputs were fetched
    (``pending`` cleared)."""

    def __init__(self, pin: bool) -> None:
        self.pin = pin
        self.bufs: Dict[str, torch.Tensor] = {}
        self.done = None  # CUDA event recorded after the slot's last copy
        self.pending = False

    def buf(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        t = self.bufs.get(name)
        if t is None or t.shape != torch.Size(shape) or t.dtype != dtype:
            # a normal tensor, never an inference one: copies into it are
            # allowed inside and outside inference mode
            with torch.inference_mode(False):
                t = self.bufs[name] = torch.empty(shape, dtype=dtype, pin_memory=self.pin)
        return t

    def record(self) -> None:
        if self.pin:
            self.done = torch.cuda.Event()
            self.done.record()


def _gather_outputs(out: Dict[str, Any], group, dp: int, b: int) -> Dict[str, Any]:
    """The host outputs of every rank of the data axis (``group``, ``dp``
    ranks, each its share in rank order) joined on the batch axis, the
    padding rows past ``b`` dropped. Every rank gets the whole batch's. A
    rank that fails before the gather leaves the others waiting in it:
    ``parallel.launch.run_ranks`` then ends them and raises."""
    parts: List[Any] = [None] * dp
    dist.all_gather_object(parts, out, group=group)

    def cat(arrays):
        return None if any(a is None for a in arrays) else np.concatenate(arrays)[:b]

    joined = {k: cat([p[k] for p in parts]) for k in out if k != "metrics"}
    joined["metrics"] = {k: cat([p["metrics"][k] for p in parts]) for k in out["metrics"]}
    return joined


# ------------------------------------------------------------------- the engine


class CellSegmentationPipeline:
    """YOLO + SAM + morphometrics pipeline on one device (default ``"cuda"``).

    Asking for CUDA where there is none raises; nothing falls back to the CPU.
    ``yolo_model_path`` (an ultralytics state dict) and ``sam_checkpoint``
    (HF ``SamModel`` or MobileSAM, ``.safetensors`` / ``.bin`` / ``.pt``) load
    weights from files; a path that does not exist raises
    ``FileNotFoundError``. A model given no file draws seeded random weights
    (the JAX package's numpy init). With ``encoder_parallel="sp"`` or
    ``"tp"`` it is one rank of a ``torch.distributed`` program:
    ``process_group`` (default: the mesh's 'sp' or 'tp' axis, else the world
    group) holds the ranks, each calls the pipeline on the same batch.
    ``params`` = (YOLO tree, SAM tree) in the JAX layout replaces both the
    files and the init.

    ``mesh`` (a :class:`~..parallel.mesh.RankMesh`, e.g. ``make_mesh(dp=2)``)
    makes the pipeline one rank of a data-parallel program, the JAX engine's
    ``mesh=``: each rank of the data axis builds the same weights (from the
    seed or the files), runs its share of every batch, and returns the whole
    batch's outputs; the ranks share one run id and only the mesh's first
    rank writes files. ``fused_call`` and ``detect_batch_arrays`` stay on
    the rank's own batch. With ``encoder_parallel`` an 'sp' or 'tp' axis
    beside the data axis holds each share's encoder group (dp x sp, dp x
    tp). A caller that replaces ``sam_params`` or ``yolo_params`` gets stages
    built anew from the new trees (a tp rank's shard re-cut), not the old
    weights.
    """

    def __init__(
        self,
        yolo_model_path: Optional[Union[str, Path]] = None,
        sam_model_type: str = "facebook/sam-vit-base",
        device: Union[str, torch.device] = "cuda",
        sam_checkpoint: Optional[Union[str, Path]] = None,
        options: Optional[PipelineOptions] = None,
        seed: int = 0,
        sam_config: Optional[SamTPUConfig] = None,
        yolo_config: Optional[YoloConfig] = None,
        process_group=None,
        params: Optional[Tuple[Any, Any]] = None,
        mesh=None,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CellSegmentationPipeline(device='cuda'): no CUDA device")
        self.sam_model_type = sam_model_type
        self.options = options or PipelineOptions()
        self.process_group = process_group
        if self.options.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.options.quant!r}: one of {QUANT_MODES}")
        if self.options.hull_mode not in HULL_MODES:
            raise ValueError(f"unknown hull_mode {self.options.hull_mode!r}: one of {HULL_MODES}")
        if self.options.tinyvit_mbconv_compute not in COMPUTE_MODES:
            raise ValueError(f"tinyvit_mbconv_compute must be one of {COMPUTE_MODES}, got "
                             f"{self.options.tinyvit_mbconv_compute!r}")
        if self.options.encoder_parallel not in ENCODER_PARALLEL:
            raise ValueError(f"encoder_parallel must be one of {ENCODER_PARALLEL}, got "
                             f"{self.options.encoder_parallel!r}")
        self._stage_src = None
        self.yolo_config = yolo_config or yolov8n()
        # the name gives the family; ``sam_config`` its sizes
        named = SAM_CONFIGS.get(sam_model_type)
        if named is None and sam_config is None:
            raise ValueError(f"unknown SAM model type: {sam_model_type}")
        self.sam_config = sam_config if named is None else named().sized(sam_config)
        self.sam_config.refuse(quant=self.options.quant,
                               encoder_parallel=self.options.encoder_parallel,
                               checkpoint=sam_checkpoint)
        if params is None:
            self._initialize_models(yolo_model_path, sam_checkpoint, seed)
        elif yolo_model_path is not None or sam_checkpoint is not None:
            raise ValueError("CellSegmentationPipeline: params= replaces the checkpoint files; "
                             "pass either params or yolo_model_path / sam_checkpoint")
        else:
            self.yolo_params, self.sam_params = params
        self._stage_cache: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._adapted_params: Dict[Tuple[int, int], Any] = {}
        self.run_id = f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
        self._set_mesh(mesh)
        self._slots: List[_Slot] = []
        self._slot_next = 0

    def _set_mesh(self, mesh) -> None:
        """The data axis of ``mesh`` ('dp', else the first axis that is not
        'sp' or 'tp'), this rank's place on it, the run id of the mesh's
        first rank, and ``writes``: whether this rank writes the run's
        files (the mesh's first rank; every pipeline without a mesh). An axis
        beside the data axis is the encoder's group where
        ``encoder_parallel`` names it, else ranks that repeat the same work
        (as a JAX mesh replicates over an axis a program does not shard
        on)."""
        self.mesh = mesh
        self._dp, self._dp_axis, self._dp_group, self.writes = 1, None, None, True
        if mesh is None:
            return
        if not mesh.contains:
            raise ValueError(f"this rank is not one of the mesh's ranks {mesh.ranks.tolist()}")
        names = mesh.axis_names
        axis = "dp" if "dp" in names else next((a for a in names if a not in ("sp", "tp")), None)
        if axis is not None and mesh.shape[axis] > 1:
            self._dp, self._dp_axis = mesh.shape[axis], axis
            self._dp_group = mesh.axis_group(axis)
        if mesh.group is not None and mesh.size > 1:
            box = [self.run_id]
            dist.broadcast_object_list(box, src=mesh.first, group=mesh.group)
            self.run_id = box[0]
            self.writes = dist.get_rank() == mesh.first

    def _initialize_models(self, yolo_path, sam_ckpt, seed: int) -> None:
        """Each model from its file where one is given, else a random init on
        the host with the JAX engine's sub-seeds: YOLO's 2s, SAM's as its
        family draws them (2s + 1; MobileSAM's TinyViT s + 1)."""
        for path in (yolo_path, sam_ckpt):
            if path is not None and not Path(path).exists():
                raise FileNotFoundError(f"checkpoint not found: {path}")
        if yolo_path is not None:
            logger.info("Loading YOLO weights from %s", yolo_path)
            self.yolo_params = load_yolo_params(str(yolo_path), self.yolo_config)
        else:
            self.yolo_params = init_yolo_params(2 * seed, self.yolo_config)
        if sam_ckpt is not None:
            logger.info("Loading SAM weights from %s", sam_ckpt)
        self.sam_params = self.sam_config.params(seed, None if sam_ckpt is None else str(sam_ckpt))

    def _sam_params_for(self, scfg: SamTPUConfig):
        """The SAM tree for the stage configuration ``scfg``, adapted to its
        canvas where the family's weights depend on it (cached per stage
        configuration)."""
        if scfg not in self._adapted_params:
            self._adapted_params[scfg] = self.sam_config.adapt_params(self.sam_params, scfg)
        return self._adapted_params[scfg]

    def _stages(self, h: int, w: int) -> Dict[str, Any]:
        """Models and stage callables specialised for frame shape (h, w),
        built anew when the caller has replaced a parameter tree."""
        src = (self.yolo_params, self.sam_params)
        if self._stage_src is None or any(a is not b for a, b in zip(src, self._stage_src)):
            self._stage_cache.clear()
            self._adapted_params.clear()
            self._stage_src = src
        key = (h, w)
        if key not in self._stage_cache:
            opts, ycfg = self.options, self.yolo_config
            scfg = self.sam_config.for_frame(h, w, opts.sam_encoder_size)
            group = self._encoder_group() if opts.encoder_parallel != "none" else None
            sam_tree = self._sam_params_for(scfg)
            if opts.quant == "int8":
                sam_tree = quantize_sam_encoder_params(
                    _round_floating(sam_tree, opts.compute_dtype))
            if group is not None and opts.encoder_parallel == "tp":
                sam_tree = shard_sam_encoder_tp(sam_tree, scfg, dist.get_world_size(group),
                                                dist.get_rank(group))
            yolo, sam = from_jax_params(
                self.yolo_params, sam_tree, self.device, opts.compute_dtype,
                yolo_config=ycfg, sam_config=scfg, conv2d_fused=opts.conv2d_fused,
                tinyvit_mbconv_compute=opts.tinyvit_mbconv_compute,
            )
            self._stage_cache[key] = {
                "scfg": scfg,
                "detect": lambda img: detect_stage(yolo, img, ycfg, opts),
                # ``mark`` makes the spans inside a stage (the model's own)
                "embed": lambda img, mark=span: embed_stage(sam, img, scfg, opts, group, mark),
                "segment": lambda feats, boxes, valid, mark=span: segment_stage(
                    sam, feats, boxes, valid, (h, w), scfg, opts, mark),
                "metrics": lambda crops, offs, gray: metrics_stage(crops, offs, gray, (h, w), opts),
                "yolo": yolo,
                "sam": sam,
            }
        return self._stage_cache[key]

    def _encoder_group(self):
        """The process group of ``encoder_parallel`` (None where the mesh's
        axis has extent 1: the encoder runs alone); the errors mirror the
        JAX engine's ``_parallel_embed`` (``engine.py:778-799``), int8
        weights refused by the sp and tp encoders."""
        kind = self.options.encoder_parallel
        self.sam_config.refuse(self.sam_params, encoder_parallel=kind)
        if self.process_group is not None:
            return self.process_group
        if self.mesh is not None:
            if kind not in self.mesh.axis_names or self.mesh.group is None:
                raise ValueError(f"encoder_parallel={kind!r} with a mesh needs a {kind!r} axis "
                                 f"over the ranks of a process group, got {self.mesh.shape} "
                                 f"(make_encoder_parallel_mesh({kind!r}, N))")
            if self.mesh.shape[kind] == 1:
                return None
            return self.mesh.axis_group(kind)
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(f"encoder_parallel={kind!r} requires a torch.distributed process "
                             "group (init_process_group, or process_group=; "
                             "parallel.launch.run_ranks starts ranks)")
        return dist.group.WORLD

    # -- array-level API -------------------------------------------------------

    def _acquire_slot(self) -> _Slot:
        """The next host slot in turn, once its last copies are done. There
        is one slot a batch in flight (``E2E_INFLIGHT``) and one for the next;
        holding more unfetched batches raises: their outputs would be
        overwritten."""
        while len(self._slots) < int(os.environ.get("E2E_INFLIGHT", "2")) + 1:
            self._slots.append(_Slot(pin=self.device.type == "cuda"))
        slot = self._slots[self._slot_next % len(self._slots)]
        if slot.pending:
            raise RuntimeError(f"{len(self._slots)} batches in flight and none fetched: "
                               "fetch one (_fetch_outputs) before dispatching another")
        self._slot_next += 1
        if slot.done is not None:
            with span("slot_wait"):
                slot.done.synchronize()
        return slot

    def _images_to_device(self, images: np.ndarray, slot: Optional[_Slot] = None) -> torch.Tensor:
        """uint8 batch -> device tensor; replicated-gray RGB goes as one channel
        (a third of the bytes; :func:`_ensure_rgb` broadcasts it back). On a
        CUDA pipeline the batch is staged in the slot's pinned buffer and
        copied without blocking the host."""
        if images.ndim == 4 and images.shape[-1] == 3:
            c0 = images[..., 0]
            if np.array_equal(c0, images[..., 1]) and np.array_equal(c0, images[..., 2]):
                images = c0
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        slot = slot or self._acquire_slot()
        stage = slot.buf("images", images.shape, torch.uint8)
        np.copyto(stage.numpy(), images)
        dev = stage.to(self.device, non_blocking=True)
        slot.record()
        return dev

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start_fetch(self, slot: _Slot, outputs, fetch_masks: bool) -> Dict[str, Any]:
        """Queue the device -> host copies of one batch's row pack and, with
        ``fetch_masks``, its bitpacked crops into the slot; no host sync.
        Returns the handle :meth:`_fetch_outputs` takes."""
        boxes, scores, valid, crops, offs, mets = outputs
        mets = dict(mets)
        token = mets.pop(MASK_TOKEN, None)
        csv = _pack_csv_outputs(boxes, scores, valid, offs, mets, token)
        csv = slot.buf("csv", csv.shape, csv.dtype).copy_(csv, non_blocking=True)
        packed = None
        if fetch_masks:
            packed = pack_bits(crops)
            packed = slot.buf("packed", packed.shape, packed.dtype).copy_(packed,
                                                                          non_blocking=True)
        slot.record()
        slot.pending = True
        return {"slot": slot, "csv": csv, "packed": packed, "cm": crops.shape[-1],
                "keys": sorted(mets), "token": token is not None}

    @torch.inference_mode()
    def _dispatch_batch(self, images: np.ndarray, fetch_masks: bool = True) -> Dict[str, Any]:
        """Upload a uint8 batch, launch the four stages and the pack, and queue
        the fetch, with no host sync: the building block of
        :meth:`process_directory`, where batch i computes while batch i-1's
        outputs come back and batch i+1 decodes on the host. Under a mesh
        this rank dispatches its share, and the fetch gathers the batch. The
        handle carries the batch's id (``"batch"``), which the dispatch's and
        the fetch's spans share (``utils/spans.py``)."""
        batch = next_batch()
        with span("dispatch", batch):
            gather = None
            if self._dp > 1:
                images, b = self._dp_share(images)
                gather = (self._dp_group, self._dp, b)
            slot = self._acquire_slot()
            with span("upload"):
                dev_images = self._images_to_device(images, slot)
            outputs = self.fused_call(dev_images)
            with span("pack"):
                h = self._start_fetch(slot, outputs, fetch_masks)
        h["gather"] = gather
        h["batch"] = batch
        return h

    @staticmethod
    def _fetch_outputs(h: Dict[str, Any]) -> Dict[str, Any]:
        """Wait for one batch's copies (its own event, never the whole
        device) and split them into host arrays: boxes (B, K, 4), scores,
        valid, mask_crops (B, K, cm, cm) bool or None, offsets (B, K, 2),
        metrics {key: (B, K)}; on SAM 2 also ``mask_token`` (B, K) int32,
        the token each slot's mask came from. Every packed field is exact in
        fp32, and the arrays returned are the caller's own (the slot's
        buffers are reused). A handle of a mesh's rank gathers the batch's outputs over
        the data axis (a collective: every rank fetches in the same order)."""
        with span("fetch", h.get("batch")):
            slot = h["slot"]
            if slot.done is not None:
                with span("fetch_wait"):
                    slot.done.synchronize()
            with span("unpack"):
                flat = h["csv"].numpy().copy()  # (B, K, 8 + M) fp32
                mask_crops = None
                if h["packed"] is not None:
                    # unpackbits gives exact 0/1 bytes, so the bool view is free
                    mask_crops = np.unpackbits(h["packed"].numpy(),
                                               axis=-1)[..., :h["cm"]].view(np.bool_)
                slot.pending = False
                out = {
                    "boxes": flat[..., :4],
                    "scores": flat[..., 4],
                    "valid": flat[..., 5] > 0.5,
                    "mask_crops": mask_crops,
                    "offsets": flat[..., 6:8].astype(np.int32),
                    "metrics": {key: flat[..., 8 + i] for i, key in enumerate(h["keys"])},
                }
                if h["token"]:
                    out[MASK_TOKEN] = flat[..., -1].astype(np.int32)
                return out if h.get("gather") is None else _gather_outputs(out, *h["gather"])

    def _dp_share(self, images: np.ndarray) -> Tuple[np.ndarray, int]:
        """(this rank's share of the batch, the batch size): the batch padded
        with zero frames to a multiple of dp (the JAX engine's
        ``_images_to_device`` under a mesh), this rank's contiguous slice."""
        b = int(images.shape[0])
        pad = (-b) % self._dp
        if pad:
            images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), images.dtype)])
        return images[data_shard(self.mesh, images.shape[0], self._dp_axis)], b

    @torch.inference_mode()
    def process_batch_arrays(
        self,
        images: np.ndarray,
        timings: Optional[Dict[str, float]] = None,
        fetch_masks: bool = True,
        fetch_outputs: bool = True,
    ) -> Optional[Dict[str, Any]]:
        """Run the four stages on a uint8 batch, (B, H, W, 3) or (B, H, W).

        Returns host arrays as :meth:`_fetch_outputs` gives them (mask_crops
        None when ``fetch_masks`` is False: the bitpack is skipped).
        ``timings`` accumulates per-stage seconds (device synchronised) under
        the reference's keys; with ``fetch_outputs=False`` only the timings
        are produced. Under a mesh every rank runs its share, ``timings``
        holds its own stages', and the outputs are the whole batch's,
        gathered over the data axis.
        """
        if self._dp == 1:
            return self._process_local(images, timings, fetch_masks, fetch_outputs)
        share, b = self._dp_share(images)
        out = self._process_local(share, timings, fetch_masks, fetch_outputs)
        return None if out is None else _gather_outputs(out, self._dp_group, self._dp, b)

    def _process_local(self, images: np.ndarray, timings, fetch_masks: bool,
                       fetch_outputs: bool) -> Optional[Dict[str, Any]]:
        """:meth:`process_batch_arrays` on this rank's device alone: each stage
        synchronised, and with ``timings`` timed under its key, each span
        inside a stage under its name."""

        @contextlib.contextmanager
        def timed(name, key):  # synchronised after, timed where there are timings
            t0 = time.perf_counter()
            with span(name):
                yield
            self._sync()
            if timings is not None:
                timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0

        @contextlib.contextmanager
        def inner(name):  # a span inside a stage, synchronised on entry too
            self._sync()
            with timed(name, name):
                yield

        slot = self._acquire_slot()
        dev_images = self._images_to_device(images, slot)
        outputs = self._run_stages(dev_images, lambda name: timed(name, _TIMING_KEYS[name]),
                                   inner if timings is not None else span)
        if not fetch_outputs:
            return None
        return self._fetch_outputs(self._start_fetch(slot, outputs, fetch_masks))

    def _run_stages(self, images: torch.Tensor, stage=span, mark=span):
        """The four stages on a device batch: (boxes, scores, valid, crops,
        offsets, metrics), with the chosen token a slot (where the model
        chooses one) beside the metrics under ``MASK_TOKEN``. ``stage(name)``
        wraps each stage (its span, which the synchronised path also times);
        ``mark`` makes the spans inside a stage."""
        st = self._stages(images.shape[1], images.shape[2])
        with stage("detect"):
            boxes, scores, valid = st["detect"](images)
        with stage("embed"):
            feats = st["embed"](images, mark)
        with stage("segment"):
            crops, offs, *token = st["segment"](feats, boxes, valid, mark)
        with stage("metrics"):
            mets = st["metrics"](crops, offs, _gray_f32(images))
        if token:
            mets[MASK_TOKEN] = token[0]
        return boxes, scores, valid, crops, offs, mets

    @torch.inference_mode()
    def fused_call(self, images: torch.Tensor):
        """All four stages on a device batch, no host sync; returns device
        tensors (boxes, scores, valid, crops, offsets, metrics). Under a mesh
        it runs the batch it is given on this rank alone."""
        return self._run_stages(images)

    @torch.inference_mode()
    def fused_call_chunked(self, images: torch.Tensor):
        """N fused batches in one call: ``images`` is a device tensor
        (N, B, H, W[, C]); the batches are launched back to back with no host
        sync (the JAX engine's ``lax.map``), and every output is stacked on a
        leading N axis."""
        outs = [self.fused_call(images[i]) for i in range(images.shape[0])]
        stacked = [torch.stack([o[j] for o in outs]) for j in range(5)]
        mets = {key: torch.stack([o[5][key] for o in outs]) for key in outs[0][5]}
        return (*stacked, mets)

    @torch.inference_mode()
    def detect_batch_arrays(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """YOLO-only path: uint8 (B, H, W[, 3]) -> boxes/scores/valid on host."""
        st = self._stages(images.shape[1], images.shape[2])
        boxes, scores, valid = st["detect"](self._images_to_device(images))
        return {"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
                "valid": valid.cpu().numpy()}

    # -- host-level helpers -----------------------------------------------------

    @staticmethod
    def _metrics_row(metrics: Dict[str, np.ndarray], b: int, k: int) -> Dict[str, Any]:
        row = {}
        for key in METRIC_KEYS:
            v = float(metrics[key][b, k])
            row[key] = int(round(v)) if key in INT_METRIC_KEYS else v
        return row

    def _results_from_outputs(
        self,
        out: Dict[str, Any],
        image_paths: Sequence[Union[str, Path]],
        n_valid_images: int,
    ) -> List[ProcessingResult]:
        """Per-image results with one metric row per valid cell."""
        valid = np.asarray(out["valid"][:n_valid_images], dtype=bool)
        cols = {}
        for key in METRIC_KEYS:
            arr = out["metrics"][key][:n_valid_images]
            if key in INT_METRIC_KEYS:
                cols[key] = np.round(arr).astype(np.int64)
            else:
                cols[key] = np.asarray(arr, dtype=np.float64)
        results = []
        for i in range(n_valid_images):
            kidx = np.flatnonzero(valid[i])
            per_key = {key: cols[key][i, kidx].tolist() for key in METRIC_KEYS}
            cell_metrics_rows = [
                {key: per_key[key][j] for key in METRIC_KEYS} for j in range(len(kidx))
            ]
            results.append(
                ProcessingResult(
                    image_path=str(image_paths[i]),
                    cell_metrics=cell_metrics_rows,
                    num_cells=len(cell_metrics_rows),
                    timing={},
                )
            )
        return results

    def _load_image(self, image_path: Union[str, Path]) -> np.ndarray:
        """Load an image as RGB uint8 (reference ``pipeline.py:206-210``)."""
        return load_image(image_path)

    # -- public single-image / directory API -------------------------------------

    @torch.inference_mode()
    def process_single_image(
        self,
        image_path: Union[str, Path],
        output_path: Union[str, Path],
        save_visualizations: bool = True,
    ) -> ProcessingResult:
        """Process one image (API parity: reference ``pipeline.py:126-204``)."""
        timings: Dict[str, float] = {}
        t0 = time.time()
        image = self._load_image(image_path)
        timings["image_load"] = time.time() - t0

        out = self.process_batch_arrays(image[None], timings)
        result = self._results_from_outputs(out, [image_path], 1)[0]

        t0 = time.time()
        if save_visualizations and self.writes:
            from .visualize import save_visualizations as save_vis

            try:
                save_vis(image, out["mask_crops"][0], out["offsets"][0], out["boxes"][0],
                         out["valid"][0], result.cell_metrics, Path(output_path),
                         Path(image_path).stem)
            except Exception as e:  # visualization failures are non-fatal
                logger.warning("Visualization failed for %s: %s", image_path, e)
        timings["visualization"] = time.time() - t0
        timings["sam_postprocess_total"] = timings.get("sam_postprocess_total", 0.0)
        timings["total_time"] = time.time() - t0 + sum(
            v for k, v in timings.items() if k not in ("total_time", "visualization")
        )
        timings["cells_processed"] = result.num_cells
        result.timing = timings
        logger.info("Processed %s: %d cells detected", Path(image_path).name, result.num_cells)
        return result

    @torch.inference_mode()
    def process_directory(
        self,
        input_dir: Union[str, Path],
        output_dir: Union[str, Path],
        save_visualizations: bool = False,
        image_paths: Optional[Sequence[Path]] = None,
        progress: bool = True,
    ) -> BatchProcessingResult:
        """Process a folder of images in device batches (API parity: reference
        ``pipeline.py:212-263``) into ``{output_dir}/{run_id}/``.

        Batches overlap: the loader decodes ahead on a thread (numpy only; no
        torch work leaves this thread), each batch is dispatched without a
        sync (:meth:`_dispatch_batch`), and the batch ``E2E_INFLIGHT`` (2)
        dispatches back is fetched and assembled while later ones compute.
        Per-stage timing rows come from a synced sample sub-batch
        (``E2E_SAMPLE_BATCH`` images, 32) at the first batch and every 16th;
        a run of one batch or fewer takes the synced stage path alone.
        ``E2E_PREFETCH_DEPTH`` (3) bounds the decoded batches queued.
        ``last_directory_stats`` holds the run's host-side wall seconds by leg.
        Under a mesh every rank decodes every batch and returns every row;
        only the mesh's first rank writes the run directory's files.
        """
        from .loader import batched_image_loader, prefetch_iterator

        input_dir = Path(input_dir)
        if image_paths is None and not input_dir.is_dir():
            raise FileNotFoundError(f"input directory does not exist: {input_dir}")
        output_dir = Path(output_dir) / self.run_id
        if self.writes:
            output_dir.mkdir(parents=True, exist_ok=True)

        files = list(image_paths) if image_paths is not None else list_image_files(input_dir)
        results: List[ProcessingResult] = []
        total_timing = initialize_timing_dict()
        metrics_data: List[Dict[str, Any]] = []
        timing_data: List[Dict[str, Any]] = []

        # per-run config snapshot (the reference snapshotted its parameters)
        if self.writes:
            with open(output_dir / "pipeline_parameters.json", "w") as f:
                snap = {
                    k: (str(v) if not isinstance(v, (int, float, bool, type(None))) else v)
                    for k, v in dataclasses.asdict(self.options).items()
                }
                snap.update({"sam_model_type": self.sam_model_type, "run_id": self.run_id})
                json.dump(snap, f, indent=2)

        bsz = self.options.batch_size
        depth = int(os.environ.get("E2E_PREFETCH_DEPTH", "3"))
        inflight = int(os.environ.get("E2E_INFLIGHT", "2"))
        sample_n = max(1, int(os.environ.get("E2E_SAMPLE_BATCH", "32")))
        batches = prefetch_iterator(
            batched_image_loader(files, bsz, skipped_report=(
                output_dir / "skipped_images.txt" if self.writes else None)),
            depth=depth,
        )
        few = len(files) <= bsz
        pending: List[Tuple[Any, np.ndarray]] = []
        sampled: Dict[str, float] = {}
        stats = {"decode_s": 0.0, "dispatch_s": 0.0, "fetch_s": 0.0,
                 "assemble_s": 0.0, "sample_sync_s": 0.0, "vis_s": 0.0,
                 "n_images": 0, "n_batches": 0, "n_sample_batches": 0}
        wall_t0 = time.perf_counter()

        def run_batch(timed, batch_imgs, batch_paths, n_valid, load_s):
            timings: Dict[str, float] = {"image_load": load_s}
            stats["decode_s"] += load_s
            stats["n_batches"] += 1
            if timed and few:
                # one batch: the synced stage pass gives both results and timings
                t0 = time.perf_counter()
                out = self.process_batch_arrays(batch_imgs, timings,
                                                fetch_masks=save_visualizations)
                stats["sample_sync_s"] += time.perf_counter() - t0
                stats["n_sample_batches"] += 1
                return (out, None, batch_paths, n_valid, timings)
            if timed:
                # per-stage device seconds from a synced sub-batch; the full
                # batch then takes the overlapped path like every other
                sb = min(sample_n, len(batch_imgs))
                stage_t: Dict[str, float] = {}
                t0 = time.perf_counter()
                self.process_batch_arrays(batch_imgs[:sb], stage_t, fetch_masks=False,
                                          fetch_outputs=False)
                stats["sample_sync_s"] += time.perf_counter() - t0
                stats["n_sample_batches"] += 1
                sampled.clear()
                sampled.update({k: v / sb for k, v in stage_t.items()})
            # scaled to this batch: finish() divides by n_valid again
            timings.update({k: v * max(n_valid, 1) for k, v in sampled.items()})
            t0 = time.perf_counter()
            handles = self._dispatch_batch(batch_imgs, fetch_masks=save_visualizations)
            stats["dispatch_s"] += time.perf_counter() - t0
            return (None, handles, batch_paths, n_valid, timings)

        def finish(entry, batch_imgs):
            out, handles, batch_paths, n_valid, timings = entry
            if out is None:
                t0 = time.perf_counter()
                out = self._fetch_outputs(handles)
                stats["fetch_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            batch_results = self._results_from_outputs(out, batch_paths, n_valid)
            stats["assemble_s"] += time.perf_counter() - t0
            stats["n_images"] += n_valid

            vis_t0 = time.time()
            if save_visualizations and self.writes:
                from .visualize import save_visualizations as save_vis

                for i, res in enumerate(batch_results):
                    try:
                        img = batch_imgs[i]
                        if img.ndim == 2:  # loader-collapsed grayscale
                            img = np.repeat(img[..., None], 3, axis=-1)
                        save_vis(img, out["mask_crops"][i], out["offsets"][i], out["boxes"][i],
                                 out["valid"][i], res.cell_metrics, output_dir,
                                 Path(res.image_path).stem)
                    except Exception as e:
                        logger.warning("Visualization failed: %s", e)
            vis_s = time.time() - vis_t0
            stats["vis_s"] += vis_s
            row_t0 = time.perf_counter()

            per_img = 1.0 / max(n_valid, 1)
            for res in batch_results:
                res.timing = {
                    "image_load": timings.get("image_load", 0.0) * per_img,
                    "yolo_detection": timings.get("yolo_detection", 0.0) * per_img,
                    "sam_preprocess": timings.get("sam_preprocess", 0.0) * per_img,
                    "sam_inference_total": timings.get("sam_inference_total", 0.0) * per_img,
                    "sam_postprocess_total": 0.0,
                    "metrics_total": timings.get("metrics_total", 0.0) * per_img,
                    "visualization": vis_s * per_img,
                    "total_time": (sum(timings.values()) + vis_s) * per_img,
                    "cells_processed": res.num_cells,
                }
                update_total_timing(total_timing, res.timing)
                collect_metrics_data(metrics_data, res)
                collect_timing_data(timing_data, res)
                results.append(res)
            stats["assemble_s"] += time.perf_counter() - row_t0
            if progress:
                logger.info("processed %d/%d images (%d cells so far)", len(results), len(files),
                            int(total_timing["total_cells"]))

        for bi, (batch_imgs, batch_paths, n_valid, load_s) in enumerate(batches):
            timed = few or bi % 16 == 0
            if timed:
                # drain the batches in flight first: their device work would
                # otherwise land in the sample's first timed stage
                while pending:
                    finish(*pending.pop(0))
            pending.append((run_batch(timed, batch_imgs, batch_paths, n_valid, load_s),
                            batch_imgs))
            if len(pending) > inflight:
                finish(*pending.pop(0))
        while pending:
            finish(*pending.pop(0))

        stats["wall_s"] = time.perf_counter() - wall_t0
        # decode_s is loader time overlapped on its thread; sample_sync_s is
        # serial (device-synced stage rows); the rest is the overlapped steady state
        self.last_directory_stats = {
            k: (round(v, 4) if isinstance(v, float) else v) for k, v in stats.items()
        }
        return BatchProcessingResult(results=results, total_timing=total_timing,
                                     metrics_data=metrics_data, timing_data=timing_data)


class ParallelCellSegmentationPipeline(CellSegmentationPipeline):
    """API-parity wrapper for the reference's thread-replica pipeline
    (reference ``pipeline.py:440-643``): ``num_pipelines`` multiplies the
    device batch size, so one program runs an N x batch_size batch where the
    reference ran N thread replicas, each on its own image. Across cards,
    ``mesh=`` runs it data-parallel, as it does the base class.
    """

    def __init__(self, *args, num_pipelines: int = 2, **kwargs) -> None:
        opts = kwargs.get("options") or PipelineOptions()
        kwargs["options"] = dataclasses.replace(
            opts, batch_size=opts.batch_size * max(1, int(num_pipelines)))
        super().__init__(*args, **kwargs)
        self.num_pipelines = num_pipelines

    def process_image(self, image: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Direct ndarray API (reference ``pipeline.py:469-503``): returns
        (boxes xyxy, full-size masks, scores) for one RGB image."""
        image = np.asarray(image)
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=2)
        out = self.process_batch_arrays(image[None].astype(np.uint8))
        valid = out["valid"][0]
        h, w = image.shape[:2]
        masks = np.zeros((int(valid.sum()), h, w), dtype=bool)
        cm = out["mask_crops"].shape[-1]
        for j, k in enumerate(np.flatnonzero(valid)):
            r0, c0 = out["offsets"][0, k]
            masks[j, r0:r0 + cm, c0:c0 + cm] = out["mask_crops"][0, k]
        return out["boxes"][0][valid], masks, out["scores"][0][valid]
