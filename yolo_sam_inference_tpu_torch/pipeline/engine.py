"""The batch pipeline engine: YOLO detect -> SAM segment -> metrics.

Counterpart of ``yolo_sam_inference_tpu/pipeline/engine.py``. One image
batch runs as four stages on the pipeline's device:

* :func:`detect_stage`: letterbox -> YOLOv8 -> DFL decode -> fixed-shape NMS,
  boxes mapped back to frame pixels;
* :func:`embed_stage`: SAM preprocess -> ViT encoder once per image at the
  frame's native resolution (window 16, resolution-adapted weights), or
  TinyViT-5M for MobileSAM (``"mobile-sam"``, ``"tinyvit"``); with
  ``PipelineOptions.encoder_parallel="sp"`` the ViT encoder's token rows are
  split over the ranks of a process group (``parallel/sp.py``), and every
  rank runs the other stages on the whole batch and returns the same
  outputs;
* :func:`segment_stage`: box prompts -> two-way decoder batched over every
  prompt -> a per-prompt window of the token grid -> mask head -> bilinear
  resample onto a fixed crop around each cell;
* :func:`metrics_stage`: the 16 morphometrics per cell.

Above the stages: ``process_batch_arrays`` (stages synchronised and timed),
``fused_call`` / ``fused_call_chunked`` (device tensors, no sync), and the
directory path (``process_single_image``, ``process_directory``) that
overlaps host decode, device work and the fetch of earlier batches. Frames
go up from pinned host buffers and come back through one pinned fp32 row
pack (``_pack_csv_outputs``) and, where masks are asked for, a device-side
bitpack of the crops (:func:`pack_bits`, 1 bit a pixel).

Weights are random (the JAX package's numpy init, so one seed gives the same
weights in both); checkpoint loading is not ported yet. Parameters are cast
to ``compute_dtype`` once, when a stage set is built, not per call; with
``quant="int8"`` the encoder's qkv and MLP weights are then quantised (w8a8,
``ops/quant.py``) from the cast weights, as the JAX engine orders it.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
    TinyViTConfig,
    adapt_resolution,
    init_sam_params,
    init_tinyvit_params,
    is_tinyvit,
    sam_vit_b,
    sam_vit_h,
    sam_vit_l,
)
from ..models.yolo import YoloConfig, decode_predictions, init_yolo_params, yolov8n
from ..io.images import list_image_files, load_image
from ..ops.mbconv_fused import COMPUTE_MODES
from ..ops.metrics import INT_METRIC_KEYS, METRIC_KEYS, cell_metrics
from ..ops.nms import batched_nms
from ..ops.preprocess import letterbox_batch, sam_preprocess_batch
from ..ops.quant import quantize_sam_encoder_params
from ..ops.window_crop import window_crop
from ..parallel.sp import sam_image_encoder_sp
from ..weights import from_jax_params
from ..utils.logger import setup_logger
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
    "mobile-sam": sam_vit_b,
    "tinyvit": sam_vit_b,
}
TINYVIT_TYPES = ("mobile-sam", "tinyvit")
QUANT_MODES = ("none", "int8")
ENCODER_PARALLEL = ("none", "sp", "tp")


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
    compute_dtype: torch.dtype = torch.bfloat16
    # SAM encoder canvas: None = native resolution (smallest of 256/512/768/
    # 1024 that fits the frame); weights are adapted at stage build time
    sam_encoder_size: Optional[int] = None
    # "int8" = dynamic w8a8 quantisation of the SAM encoder's qkv/MLP
    # projections (ops/quant.py); "none" keeps compute_dtype throughout
    quant: str = "none"
    # "sp" = the ViT encoder's token rows split over the ranks of the
    # pipeline's process group (parallel/sp.py); "tp" is not ported yet
    encoder_parallel: str = "none"
    # True = every dense (k > 1) conv of YOLOv8, the SAM neck and TinyViT's
    # stems and neck on conv2d_act (K17; the JAX package's CONV2D_FUSED=1),
    # YOLO's 1x1s as its matmul; False keeps F.conv2d
    conv2d_fused: bool = False
    # MobileSAM: "bf16" runs the MBConv and merge kernels' GELUs and depthwise
    # (K14, K15) in bf16 instead of fp32 (ops/mbconv_fused.py), where the
    # JAX package's fused path would
    tinyvit_mbconv_compute: str = "fp32"

    def encoder_size_for(self, h: int, w: int) -> int:
        if self.sam_encoder_size is not None:
            return self.sam_encoder_size
        m = max(h, w)
        for size in (256, 512, 768, 1024):
            if m <= size:
                return size
        return 1024

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
    shift = torch.tensor([pad_x, pad_y, pad_x, pad_y], dtype=boxes.dtype, device=dev)
    lim = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=boxes.dtype, device=dev)
    boxes = torch.minimum(((boxes - shift) / scale).clamp(min=0.0), lim)
    boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    return boxes, scores, valid


def embed_stage(sam, images_u8: torch.Tensor, scfg: SamTPUConfig, opts: PipelineOptions,
                group=None):
    """uint8 (B, H, W[, 3]) -> SAM image embeddings (B, gs, gs, C) fp32.
    ``sam.vision`` is the ViT encoder, or TinyViT for MobileSAM (built from
    the tree's ``"tinyvit"`` subtree at the canvas ``scfg.image_size``).
    With a process ``group``, the ViT encoder runs sequence-parallel over
    its ranks."""
    pix, _, _ = sam_preprocess_batch(_ensure_rgb(images_u8), scfg.image_size)
    pix = pix.to(opts.compute_dtype)
    if group is None:
        return sam.vision(pix).float()
    return sam_image_encoder_sp(sam.vision, pix, scfg, group).float()


def _bilinear_crop_sample_window(
    win_logits: torch.Tensor,
    offset_rc: torch.Tensor,
    win_low_start: torch.Tensor,
    crop: int,
    scale_to_low: float,
) -> torch.Tensor:
    """Sample (N, crop, crop) frame-resolution logits from per-cell low-res
    windows (N, lw, lw) whose low-res origin is ``win_low_start`` (N, 2).
    Frame pixel (r, c) maps to low-res ((r + 0.5) * s - 0.5); separable
    hat-function weights, two small products per cell."""
    lw = win_logits.shape[-1]
    dev = win_logits.device
    idx = torch.arange(crop, dtype=torch.float32, device=dev)
    off = offset_rc.float()
    start = win_low_start.float()
    ly = (off[:, 0:1] + idx + 0.5) * scale_to_low - 0.5
    lx = (off[:, 1:2] + idx + 0.5) * scale_to_low - 0.5
    ly = (ly - start[:, 0:1]).clamp(0.0, lw - 1.0)
    lx = (lx - start[:, 1:2]).clamp(0.0, lw - 1.0)
    j = torch.arange(lw, dtype=torch.float32, device=dev)
    py = (1.0 - (ly[..., None] - j).abs()).clamp(min=0.0)  # (N, crop, lw)
    px = (1.0 - (lx[..., None] - j).abs()).clamp(min=0.0)
    return torch.einsum("niw,nwv,njv->nij", py, win_logits.float(), px)


def segment_stage(
    sam,
    embeddings: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    image_hw: Tuple[int, int],
    scfg: SamTPUConfig,
    opts: PipelineOptions,
):
    """Embeddings + boxes -> (mask_crops (B, K, cm, cm) bool, offsets (B, K, 2))."""
    h, w = image_hw
    b, k = boxes.shape[0], boxes.shape[1]
    cm = min(opts.metric_crop, h, w)
    gs = scfg.grid_size
    cd = opts.compute_dtype
    sam_scale = scfg.image_size / max(h, w)

    sparse = sam.prompt.boxes(boxes * sam_scale).to(cd)
    _, hyper, keys_grid = sam.mask_decoder_tokens(embeddings.to(cd), sparse)
    hyper1 = hyper[:, :1, :]  # single-mask output (multimask_output=False)

    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    off_r = (torch.round(cy).long() - cm // 2).clamp(0, h - cm)
    off_c = (torch.round(cx).long() - cm // 2).clamp(0, w - cm)
    offsets = torch.stack([off_r, off_c], dim=-1)

    # each prompt's mask is only needed inside its crop: slice a window of
    # the token grid per prompt and upscale just that
    scale_to_low = sam_scale / (scfg.image_size / scfg.low_res_size)
    scale_to_grid = scale_to_low / 4.0
    wg = min(gs, int(math.ceil(cm * scale_to_grid)) + 3)
    flat_off = offsets.reshape(b * k, 2)
    g_start = ((flat_off.float() * scale_to_grid).long() - 1).clamp(0, gs - wg)
    windows = window_crop(keys_grid, g_start[:, 0], g_start[:, 1], wg)
    logits_win = sam.decoder.mask_head(windows, hyper1)[:, 0]  # (B*K, 4wg, 4wg)

    crops = _bilinear_crop_sample_window(logits_win, flat_off, g_start * 4, cm, scale_to_low)
    mask_crops = (crops.reshape(b, k, cm, cm) > 0.0) & valid[..., None, None]
    return mask_crops, offsets


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
        image_hw, opts.num_hull_directions,
    )
    return {key: v.reshape(b, k) for key, v in mets.items()}


def _pack_csv_outputs(boxes, scores, valid, offs, mets) -> torch.Tensor:
    """Every CSV-needed per-detection output as one fp32 (B, K, 8 + M) tensor:
    [boxes(4), scores(1), valid(1), offsets(2), metrics(M) in sorted-key
    order], so one device -> host copy covers the row set. All fields are
    exact in fp32 (coordinates < 2^24)."""
    parts = [boxes.float(), scores.float()[..., None], valid.float()[..., None], offs.float()]
    parts += [mets[key].float()[..., None] for key in sorted(mets)]
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
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=crops.device)
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


# ------------------------------------------------------------------- the engine


class CellSegmentationPipeline:
    """YOLO + SAM + morphometrics pipeline on one device (default ``"cuda"``).

    Asking for CUDA where there is none raises; nothing falls back to the CPU.
    With ``encoder_parallel="sp"`` it is one rank of a ``torch.distributed``
    program: ``process_group`` (default: the world group) holds the ranks,
    each calls the pipeline on the same batch. ``params`` = (YOLO tree, SAM
    tree) in the JAX layout replaces the seeded random init.
    """

    def __init__(
        self,
        sam_model_type: str = "facebook/sam-vit-base",
        device: Union[str, torch.device] = "cuda",
        options: Optional[PipelineOptions] = None,
        seed: int = 0,
        sam_config: Optional[SamTPUConfig] = None,
        yolo_config: Optional[YoloConfig] = None,
        process_group=None,
        params: Optional[Tuple[Any, Any]] = None,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CellSegmentationPipeline(device='cuda'): no CUDA device")
        self.sam_model_type = sam_model_type
        self.options = options or PipelineOptions()
        self.process_group = process_group
        if self.options.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant mode {self.options.quant!r}: one of {QUANT_MODES}")
        if self.options.tinyvit_mbconv_compute not in COMPUTE_MODES:
            raise ValueError(f"tinyvit_mbconv_compute must be one of {COMPUTE_MODES}, got "
                             f"{self.options.tinyvit_mbconv_compute!r}")
        if self.options.encoder_parallel not in ENCODER_PARALLEL:
            raise ValueError(f"encoder_parallel must be one of {ENCODER_PARALLEL}, got "
                             f"{self.options.encoder_parallel!r}")
        self.yolo_config = yolo_config or yolov8n()
        if sam_config is not None:
            self.sam_config = sam_config
        elif sam_model_type in SAM_CONFIGS:
            self.sam_config = SAM_CONFIGS[sam_model_type]()
        else:
            raise ValueError(f"unknown SAM model type: {sam_model_type}")
        if params is None:
            self._initialize_models(seed)
        else:
            self.yolo_params, self.sam_params = params
        self._stage_cache: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self._adapted_params: Dict[Tuple[int, int], Any] = {}
        self.run_id = f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
        self._slots: List[_Slot] = []
        self._slot_next = 0

    def _initialize_models(self, seed: int) -> None:
        """Random init on the host, the JAX engine's sub-seeds (2s, 2s + 1).
        MobileSAM draws the whole SAM tree first (so the decoder's draws are
        the same), then TinyViT's from seed + 1, and drops the ViT encoder."""
        self.yolo_params = init_yolo_params(2 * seed, self.yolo_config)
        self.sam_params = init_sam_params(2 * seed + 1, self.sam_config)
        if self.sam_model_type in TINYVIT_TYPES:
            tcfg = TinyViTConfig(image_size=self.sam_config.image_size,
                                 output_channels=self.sam_config.output_channels)
            self.sam_params = dict(self.sam_params)
            self.sam_params["tinyvit"] = init_tinyvit_params(seed + 1, tcfg)
            self.sam_params.pop("vision", None)

    def _sam_params_for(self, scfg: SamTPUConfig):
        """Resolution-adapted SAM parameter tree (cached per encoder geometry).
        TinyViT has no resolution-dependent weights."""
        key = (scfg.image_size, scfg.window_size)
        if key == (self.sam_config.image_size, self.sam_config.window_size) or is_tinyvit(
                self.sam_params):
            return self.sam_params
        if key not in self._adapted_params:
            self._adapted_params[key] = adapt_resolution(self.sam_params, scfg)
        return self._adapted_params[key]

    def _stages(self, h: int, w: int) -> Dict[str, Any]:
        """Models and stage callables specialised for frame shape (h, w)."""
        key = (h, w)
        if key not in self._stage_cache:
            opts, ycfg = self.options, self.yolo_config
            group = self._encoder_group() if opts.encoder_parallel != "none" else None
            enc_size = opts.encoder_size_for(h, w)
            gs = enc_size // self.sam_config.patch_size
            # window 16 divides every grid of the native-resolution ladder
            ws = 16 if gs % 16 == 0 else self.sam_config.window_size
            scfg = dataclasses.replace(self.sam_config, image_size=enc_size, window_size=ws)
            sam_tree = self._sam_params_for(scfg)
            if opts.quant == "int8":
                sam_tree = quantize_sam_encoder_params(
                    _round_floating(sam_tree, opts.compute_dtype))
            yolo, sam = from_jax_params(
                self.yolo_params, sam_tree, self.device, opts.compute_dtype,
                yolo_config=ycfg, sam_config=scfg, conv2d_fused=opts.conv2d_fused,
                tinyvit_mbconv_compute=opts.tinyvit_mbconv_compute,
            )
            self._stage_cache[key] = {
                "scfg": scfg,
                "detect": lambda img: detect_stage(yolo, img, ycfg, opts),
                "embed": lambda img: embed_stage(sam, img, scfg, opts, group),
                "segment": lambda emb, boxes, valid: segment_stage(
                    sam, emb, boxes, valid, (h, w), scfg, opts
                ),
                "metrics": lambda crops, offs, gray: metrics_stage(
                    crops, offs, gray, (h, w), opts
                ),
                "yolo": yolo,
                "sam": sam,
            }
        return self._stage_cache[key]

    def _encoder_group(self):
        """The process group of ``encoder_parallel``; the errors mirror the
        JAX engine's ``_parallel_embed`` (``engine.py:778-799``), int8
        weights refused by :func:`sam_image_encoder_sp` at the first batch."""
        opts = self.options
        if opts.encoder_parallel == "tp":
            raise ValueError("encoder_parallel='tp' is not ported yet (parallel/tp.py; "
                             "ROADMAP.md, Queue 1): use 'sp' or 'none'")
        if is_tinyvit(self.sam_params):
            raise ValueError("encoder_parallel supports ViT SAM encoders only (TinyViT's conv "
                             "stages have no sp sharding)")
        if self.process_group is not None:
            return self.process_group
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("encoder_parallel='sp' requires a torch.distributed process group "
                             "(init_process_group, or process_group=; "
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
        csv = _pack_csv_outputs(boxes, scores, valid, offs, mets)
        csv = slot.buf("csv", csv.shape, csv.dtype).copy_(csv, non_blocking=True)
        packed = None
        if fetch_masks:
            packed = pack_bits(crops)
            packed = slot.buf("packed", packed.shape, packed.dtype).copy_(packed,
                                                                          non_blocking=True)
        slot.record()
        slot.pending = True
        return {"slot": slot, "csv": csv, "packed": packed, "cm": crops.shape[-1],
                "keys": sorted(mets)}

    @torch.inference_mode()
    def _dispatch_batch(self, images: np.ndarray, fetch_masks: bool = True) -> Dict[str, Any]:
        """Upload a uint8 batch, launch the four stages and the pack, and queue
        the fetch, with no host sync: the building block of
        :meth:`process_directory`, where batch i computes while batch i-1's
        outputs come back and batch i+1 decodes on the host."""
        slot = self._acquire_slot()
        return self._start_fetch(slot, self.fused_call(self._images_to_device(images, slot)),
                                 fetch_masks)

    @staticmethod
    def _fetch_outputs(h: Dict[str, Any]) -> Dict[str, Any]:
        """Wait for one batch's copies (its own event, never the whole
        device) and split them into host arrays: boxes (B, K, 4), scores,
        valid, mask_crops (B, K, cm, cm) bool or None, offsets (B, K, 2),
        metrics {key: (B, K)}. Every packed field is exact in fp32, and the
        arrays returned are the caller's own (the slot's buffers are
        reused)."""
        slot = h["slot"]
        if slot.done is not None:
            slot.done.synchronize()
        flat = h["csv"].numpy().copy()  # (B, K, 8 + M) fp32
        mask_crops = None
        if h["packed"] is not None:
            # unpackbits gives exact 0/1 bytes, so the bool view is free
            mask_crops = np.unpackbits(h["packed"].numpy(), axis=-1)[..., :h["cm"]].view(np.bool_)
        slot.pending = False
        return {
            "boxes": flat[..., :4],
            "scores": flat[..., 4],
            "valid": flat[..., 5] > 0.5,
            "mask_crops": mask_crops,
            "offsets": flat[..., 6:8].astype(np.int32),
            "metrics": {key: flat[..., 8 + i] for i, key in enumerate(h["keys"])},
        }

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
        are produced.
        """
        st = self._stages(images.shape[1], images.shape[2])

        def timed(key, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            self._sync()
            if timings is not None:
                timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
            return out

        slot = self._acquire_slot()
        dev_images = self._images_to_device(images, slot)
        boxes, scores, valid = timed("yolo_detection", st["detect"], dev_images)
        emb = timed("sam_preprocess", st["embed"], dev_images)
        crops, offs = timed("sam_inference_total", st["segment"], emb, boxes, valid)
        mets = timed("metrics_total", st["metrics"], crops, offs, _gray_f32(dev_images))
        if not fetch_outputs:
            return None
        return self._fetch_outputs(self._start_fetch(
            slot, (boxes, scores, valid, crops, offs, mets), fetch_masks))

    @torch.inference_mode()
    def fused_call(self, images: torch.Tensor):
        """All four stages on a device batch, no host sync; returns device
        tensors (boxes, scores, valid, crops, offsets, metrics)."""
        st = self._stages(images.shape[1], images.shape[2])
        boxes, scores, valid = st["detect"](images)
        emb = st["embed"](images)
        crops, offs = st["segment"](emb, boxes, valid)
        mets = st["metrics"](crops, offs, _gray_f32(images))
        return boxes, scores, valid, crops, offs, mets

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
        if save_visualizations:
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
        """
        from .loader import batched_image_loader, prefetch_iterator

        input_dir = Path(input_dir)
        if image_paths is None and not input_dir.is_dir():
            raise FileNotFoundError(f"input directory does not exist: {input_dir}")
        output_dir = Path(output_dir) / self.run_id
        output_dir.mkdir(parents=True, exist_ok=True)

        files = list(image_paths) if image_paths is not None else list_image_files(input_dir)
        results: List[ProcessingResult] = []
        total_timing = initialize_timing_dict()
        metrics_data: List[Dict[str, Any]] = []
        timing_data: List[Dict[str, Any]] = []

        # per-run config snapshot (the reference snapshotted its parameters)
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
            batched_image_loader(files, bsz, skipped_report=output_dir / "skipped_images.txt"),
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
            if save_visualizations:
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
    reference ran N thread replicas, each on its own image. Data parallelism
    over cards is not ported yet (``ROADMAP.md``, Queue 1 item 4).
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
