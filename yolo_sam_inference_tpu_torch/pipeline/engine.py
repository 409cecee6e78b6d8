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

Weights are random (the JAX package's numpy init, so one seed gives the same
weights in both); checkpoint loading is not ported yet. Parameters are cast
to ``compute_dtype`` once, when a stage set is built, not per call; with
``quant="int8"`` the encoder's qkv and MLP weights are then quantised (w8a8,
``ops/quant.py``) from the cast weights, as the JAX engine orders it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
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
from ..ops.mbconv_fused import COMPUTE_MODES
from ..ops.metrics import INT_METRIC_KEYS, METRIC_KEYS, cell_metrics
from ..ops.nms import batched_nms
from ..ops.preprocess import letterbox_batch, sam_preprocess_batch
from ..ops.quant import quantize_sam_encoder_params
from ..ops.window_crop import window_crop
from ..parallel.sp import sam_image_encoder_sp
from ..weights import from_jax_params
from .results import ProcessingResult

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

    def _images_to_device(self, images: np.ndarray) -> torch.Tensor:
        """uint8 batch -> device tensor; replicated-gray RGB goes as one channel
        (a third of the bytes; :func:`_ensure_rgb` broadcasts it back)."""
        if images.ndim == 4 and images.shape[-1] == 3:
            c0 = images[..., 0]
            if np.array_equal(c0, images[..., 1]) and np.array_equal(c0, images[..., 2]):
                images = np.ascontiguousarray(c0)
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def process_batch_arrays(
        self,
        images: np.ndarray,
        timings: Optional[Dict[str, float]] = None,
        fetch_masks: bool = True,
        fetch_outputs: bool = True,
    ) -> Optional[Dict[str, Any]]:
        """Run the four stages on a uint8 batch, (B, H, W, 3) or (B, H, W).

        Returns host arrays: boxes (B, K, 4), scores, valid, mask_crops
        (B, K, cm, cm) (None when ``fetch_masks`` is False), offsets (B, K, 2),
        metrics {key: (B, K)}. ``timings`` accumulates per-stage seconds
        (device synchronised) under the reference's keys; with
        ``fetch_outputs=False`` only the timings are produced.
        """
        st = self._stages(images.shape[1], images.shape[2])

        def timed(key, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            self._sync()
            if timings is not None:
                timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
            return out

        dev_images = self._images_to_device(images)
        boxes, scores, valid = timed("yolo_detection", st["detect"], dev_images)
        emb = timed("sam_preprocess", st["embed"], dev_images)
        crops, offs = timed("sam_inference_total", st["segment"], emb, boxes, valid)
        mets = timed("metrics_total", st["metrics"], crops, offs, _gray_f32(dev_images))
        if not fetch_outputs:
            return None
        flat = _pack_csv_outputs(boxes, scores, valid, offs, mets).cpu().numpy()
        keys = sorted(mets)
        return {
            "boxes": flat[..., :4],
            "scores": flat[..., 4],
            "valid": flat[..., 5] > 0.5,
            "mask_crops": crops.cpu().numpy() if fetch_masks else None,
            "offsets": flat[..., 6:8].astype(np.int32),
            "metrics": {key: flat[..., 8 + i] for i, key in enumerate(keys)},
        }

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
