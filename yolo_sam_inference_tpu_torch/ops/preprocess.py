"""Batched preprocessing: letterbox for YOLO, resize + pad + normalise for SAM.

Counterpart of ``yolo_sam_inference_tpu/ops/preprocess.py``. Images are
channels-last ``(B, H, W, C)`` tensors on the pipeline's device.

Where a frame's size differs from the resized size, both stages go through
:func:`resample_canvas`: on a CUDA tensor one launch of
``csrc/resample.cu`` reads the frame where it lies (uint8 or fp32, any
strides: a gray frame's stride-0 channel view is read once) and writes the
normalised, padded fp32 canvas; its source note says what bounds it. Each
output row's and column's band of the resampling matrix is made on the
device once (:func:`_band_on`). CPU tensors take the plain version, the
dense product :func:`resize_bilinear`; an identity resize launches nothing
on either device. ``resample_canvas.launches`` counts launches.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ._build import check, kernels
from .autograd import refuse_grad
from .constants import constant, made_once
from .fused_ln import _on_cpu

# SAM (ImageNet) normalization constants, matching SamProcessor defaults.
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)


@functools.lru_cache(maxsize=32)
def _linear_weights(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) resampling matrix of ``jax.image.resize(method=
    "linear")``: half-pixel centres and a triangle kernel whose support
    widens by the downsampling factor (antialiasing), rows normalised."""
    scale = in_len / out_len
    kernel_scale = max(scale, 1.0)
    centers = (np.arange(out_len, dtype=np.float64) + 0.5) * scale - 0.5
    j = np.arange(in_len, dtype=np.float64)
    w = np.clip(1.0 - np.abs(j[None, :] - centers[:, None]) / kernel_scale, 0.0, None)
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@made_once(maxsize=32)
def _linear_weights_on(in_len: int, out_len: int, device: torch.device,
                       dtype: torch.dtype) -> torch.Tensor:
    """:func:`_linear_weights` on ``device`` in ``dtype``, made once."""
    return torch.from_numpy(_linear_weights(in_len, out_len)).to(device, dtype)


@functools.lru_cache(maxsize=32)
def _band_table(in_len: int, out_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """The rows of :func:`_linear_weights` as bands: (out_len,) int32 starts
    and (out_len, taps) fp32 weights, ``taps`` the widest run of nonzero
    entries in a row. A row's band [start, start + taps) holds every nonzero
    entry of the row (the start is pulled back where the band would pass the
    input's end) and its weights are the matrix's own entries there."""
    w = _linear_weights(in_len, out_len)
    nz = w != 0
    first = nz.argmax(axis=1)
    last = in_len - 1 - nz[:, ::-1].argmax(axis=1)
    taps = int((last - first + 1).max())
    start = np.minimum(first, in_len - taps).astype(np.int32)
    return start, np.take_along_axis(w, start[:, None] + np.arange(taps), axis=1)


@made_once(maxsize=32)
def _band_on(in_len: int, out_len: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_band_table` on ``device``, made once."""
    start, w = _band_table(in_len, out_len)
    return torch.from_numpy(start).to(device), torch.from_numpy(w).to(device)


# the kernel's shared memory a block: under 48 KB without asking (more blocks
# an SM); csrc/resample.cu's MAX_SMEM with its opt-in
SMEM_PLAIN, SMEM_MAX = 48 * 1024, 226 * 1024


def _smem_bytes(cin: int, c: int, ty: int, tx: int, vw: int, rh: int, ky: int, kx: int,
                elem: int) -> int:
    """A block's shared memory in ``csrc/resample.cu`` (its ``layout``): the
    input window, the vertical pass, the output tile and the tile's bands,
    each rounded up to 16 bytes; rows of ``vw + 15`` rounded up to 16."""
    def r16(n: int) -> int:
        return (n + 15) // 16 * 16

    sw = r16(vw + 15)
    return (r16(cin * rh * sw * elem) + r16(cin * ty * sw * 4) + r16(ty * tx * c * 4)
            + r16(ty * ky * 4) + r16(ty * 4) + r16(tx * kx * 4) + r16(tx * 4))


def _window(in_len: int, out_len: int, n: int) -> int:
    """The most input entries the bands of n consecutive outputs reach."""
    start, w = _band_table(in_len, out_len)
    end = start + w.shape[1]
    return int((end[np.minimum(np.arange(out_len) + n - 1, out_len - 1)] - start).max())


@functools.lru_cache(maxsize=64)
def _tile_plan(in_h: int, out_h: int, in_w: int, out_w: int, cin: int, c: int,
               elem: int) -> Tuple[int, int, int, int]:
    """(ty, tx, vw, rh) for ``csrc/resample.cu``: its canvas tile, the widest
    input column window of tx consecutive resized columns and the tallest
    row window of ty consecutive resized rows. The tile starts at 16 x 64
    and shrinks, rows first, until its shared memory (:func:`_smem_bytes`)
    fits under ``SMEM_PLAIN``."""
    ky, kx = _band_table(in_h, out_h)[1].shape[1], _band_table(in_w, out_w)[1].shape[1]

    def plan(ty: int, tx: int) -> Tuple[int, int, int, int, int]:
        vw, rh = _window(in_w, out_w, tx), _window(in_h, out_h, ty)
        return ty, tx, vw, rh, _smem_bytes(cin, c, ty, tx, vw, rh, ky, kx, elem)

    ty, tx, vw, rh, smem = plan(16, 64)
    while smem > SMEM_PLAIN and tx > 1:
        ty, tx, vw, rh, smem = plan(ty // 2, tx) if ty > 1 else plan(ty, tx // 2)
    if smem > SMEM_MAX:
        raise ValueError(f"resample_canvas: bands of {ky} x {kx} taps ({in_h} x {in_w} -> "
                         f"{out_h} x {out_w}) do not fit the kernel's shared memory")
    return ty, tx, vw, rh


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize (half-pixel centres, antialiased on downsample), NHWC float."""
    h, w = img.shape[-3], img.shape[-2]
    if h == out_h and w == out_w:
        return img
    wy = _linear_weights_on(h, out_h, img.device, torch.float32)
    wx = _linear_weights_on(w, out_w, img.device, torch.float32)
    return torch.einsum("oh,...hwc,pw->...opc", wy, img, wx)


def resample_canvas_plain(images: torch.Tensor, hw: Tuple[int, int], size: int,
                          offset: Tuple[int, int], sub: Sequence[float], div: Sequence[float],
                          pad: float) -> torch.Tensor:
    """(B, H, W, C) frames -> (B, size, size, C) fp32: the frames resized to
    ``hw`` = (nh, nw) by :func:`resize_bilinear` at ``offset`` = (row, col)
    of the canvas as ``(x - sub[c]) / div[c]``, ``pad`` everywhere else."""
    (nh, nw), (oy, ox) = hw, offset
    b, c, dev = images.shape[0], images.shape[3], images.device
    resized = resize_bilinear(images.float(), nh, nw)
    out = torch.full((b, size, size, c), pad, dtype=torch.float32, device=dev)
    out[:, oy:oy + nh, ox:ox + nw] = ((resized - constant(tuple(sub), torch.float32, dev))
                                      / constant(tuple(div), torch.float32, dev))
    return out


def resample_canvas(images: torch.Tensor, hw: Tuple[int, int], size: int,
                    offset: Tuple[int, int], sub: Sequence[float], div: Sequence[float],
                    pad: float) -> torch.Tensor:
    """See :func:`resample_canvas_plain`. Frames are uint8 or fp32 with up to
    4 channels, of any strides. CUDA tensors launch ``csrc/resample.cu``:
    the same bands of the same fp32 weights, summed in another order, the
    same epilogue (IEEE division); a channel of stride 0 is resampled once
    and written to every channel."""
    b, h, w, c = images.shape
    (nh, nw), (oy, ox) = hw, offset
    if images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"resample_canvas takes uint8 or fp32 frames, got {images.dtype}")
    if not (1 <= c <= 4 and len(sub) == len(div) == c):
        raise ValueError(f"resample_canvas: {c} channels with {len(sub)} offsets and "
                         f"{len(div)} divisors (1 to 4 channels, one of each a channel)")
    if not (0 < nh and 0 < nw and 0 <= oy and 0 <= ox and oy + nh <= size and ox + nw <= size):
        raise ValueError(f"resample_canvas: a {nh} x {nw} image at {offset} leaves the "
                         f"{size} x {size} canvas")
    if _on_cpu(images):
        return resample_canvas_plain(images, hw, size, offset, sub, div, pad)
    refuse_grad("resample_canvas", images)
    dev, fp32 = images.device, images.dtype == torch.float32
    sb, sh, sw, sc = images.stride()
    cin = 1 if c > 1 and sc == 0 else c
    # whole 16-byte chunks of a gray uint8 frame's rows where they are aligned
    vec = not fp32 and cin == 1 and sw == 1 and sh % 16 == 0 and sb % 16 == 0 \
        and images.data_ptr() % 16 == 0
    ys, wy = _band_on(h, nh, dev)
    xs, wx = _band_on(w, nw, dev)
    ty, tx, vw, rh = _tile_plan(h, nh, w, nw, cin, c, images.element_size())
    sub_t = constant(tuple(sub), torch.float32, dev)
    div_t = constant(tuple(div), torch.float32, dev)
    out = torch.empty((b, size, size, c), dtype=torch.float32, device=dev)
    err = kernels().ysi_resample(
        images.data_ptr(), int(fp32), sb, sh, sw, sc, int(vec), b, c, cin, ys.data_ptr(),
        wy.data_ptr(), wy.shape[1], xs.data_ptr(), wx.data_ptr(), wx.shape[1], nh, nw, oy, ox,
        out.data_ptr(), size, size, sub_t.data_ptr(), div_t.data_ptr(), pad, ty, tx, vw, rh,
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "resample_canvas")
    resample_canvas.launches += 1
    return out


resample_canvas.launches = 0


def letterbox_batch(
    images: torch.Tensor, size: int, pad_value: float = 114.0
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """(B, H, W, 3) -> ((B, size, size, 3) fp32 in [0, 1], scale, (pad_x, pad_y)):
    aspect-preserving fit with centred gray padding (ultralytics convention)."""
    b, h, w, c = images.shape
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    if (nh, nw) != (h, w):
        pad = float(np.float32(pad_value) / np.float32(255.0))
        out = resample_canvas(images, (nh, nw), size, (pad_y, pad_x), (0.0,) * c, (255.0,) * c,
                              pad)
        return out, r, (pad_x, pad_y)
    out = torch.full((b, size, size, c), pad_value, dtype=torch.float32, device=images.device)
    out[:, pad_y:pad_y + nh, pad_x:pad_x + nw] = images
    return out / 255.0, r, (pad_x, pad_y)


def sam_preprocess_batch(
    images: torch.Tensor, size: int = 1024
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Resize the longest side to ``size``, ImageNet-normalise, zero-pad
    bottom/right (SamProcessor semantics). Returns (batch, scale, (nh, nw))."""
    b, h, w, c = images.shape
    r = size / max(h, w)
    nh, nw = int(h * r + 0.5), int(w * r + 0.5)
    if (nh, nw) != (h, w):
        return resample_canvas(images, (nh, nw), size, (0, 0), SAM_MEAN, SAM_STD, 0.0), r, (nh, nw)
    mean = constant(SAM_MEAN, torch.float32, images.device)
    std = constant(SAM_STD, torch.float32, images.device)
    out = torch.zeros((b, size, size, c), dtype=torch.float32, device=images.device)
    out[:, :nh, :nw] = (images.float() - mean) / std
    return out, r, (nh, nw)


def scale_boxes_from_letterbox(
    boxes: torch.Tensor, scale: float, pad: Tuple[int, int]
) -> torch.Tensor:
    """Map xyxy boxes from letterboxed coords back to original image coords."""
    px, py = pad
    shift = torch.tensor([px, py, px, py], dtype=boxes.dtype, device=boxes.device)
    return (boxes - shift) / scale


def boxes_to_sam_coords(boxes: torch.Tensor, sam_scale: float) -> torch.Tensor:
    """Map xyxy boxes in original-image coords to SAM encoder-input coords."""
    return boxes * sam_scale


def upsample_masks_bilinear(masks: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of the last two axes, (..., h, w) -> (..., out_h, out_w),
    as ``jax.image.resize(method="bilinear")``: half-pixel centres,
    antialiased where it shrinks; non-float masks are resized as fp32."""
    h, w = masks.shape[-2], masks.shape[-1]
    if h == out_h and w == out_w:
        return masks
    x = masks if masks.is_floating_point() else masks.float()
    wy = _linear_weights_on(h, out_h, x.device, x.dtype)
    wx = _linear_weights_on(w, out_w, x.device, x.dtype)
    return torch.einsum("oh,...hw,pw->...op", wy, x, wx)
