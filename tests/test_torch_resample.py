"""The frames' resample onto a stage's canvas (``ops/preprocess.py``), on the CPU.

The kernel (``csrc/resample.cu``) runs only on a card; here: its band tables
reproduce every row of the dense resampling matrix the plain version
multiplies by; the letterbox and SAM's preprocess on CPU tensors are bit for
bit the code they replaced (``_letterbox_before`` / ``_sam_before``, the
dense product everywhere); the kernel's tile walk, emulated in numpy with
the tile plan the wrapper hands it, stays inside its shared tiles and sums
the bands to the float64 resample within 5e-4 on the 0-255 scale; the
wrapper refuses what the kernel does not take.
"""

import numpy as np
import pytest
import torch

from yolo_sam_inference_tpu_torch.ops import preprocess
from yolo_sam_inference_tpu_torch.ops.preprocess import (
    SAM_MEAN,
    SAM_STD,
    _band_table,
    _linear_weights,
    _tile_plan,
    letterbox_batch,
    resample_canvas,
    resample_canvas_plain,
    resize_bilinear,
    sam_preprocess_batch,
)
from yolo_sam_inference_tpu_torch.pipeline.engine import _ensure_rgb

torch.set_num_threads(2)

# (in, out) lengths: SAM's 2048 -> 1024, the letterbox's 2048 -> 640 and
# 1536 -> 480, an upsample and an odd size
BANDS = [(2048, 1024), (2048, 640), (512, 640), (1000, 333), (1536, 480)]


def _letterbox_before(images, size, pad_value=114.0):
    b, h, w, c = images.shape
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    resized = resize_bilinear(images.float(), nh, nw)
    pad_y, pad_x = (size - nh) // 2, (size - nw) // 2
    out = torch.full((b, size, size, c), pad_value, dtype=torch.float32, device=images.device)
    out[:, pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return out / 255.0, r, (pad_x, pad_y)


def _sam_before(images, size=1024):
    b, h, w, c = images.shape
    r = size / max(h, w)
    nh, nw = int(h * r + 0.5), int(w * r + 0.5)
    resized = resize_bilinear(images.float(), nh, nw)
    mean = torch.tensor(SAM_MEAN, dtype=torch.float32)
    std = torch.tensor(SAM_STD, dtype=torch.float32)
    out = torch.zeros((b, size, size, c), dtype=torch.float32, device=images.device)
    out[:, :nh, :nw] = (resized - mean) / std
    return out, r, (nh, nw)


def _frames(seed, b, h, w, gray):
    rng = np.random.default_rng(seed)
    if gray:
        return _ensure_rgb(torch.from_numpy(rng.integers(0, 256, (b, h, w), dtype=np.uint8)))
    return torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("n_in,n_out", BANDS)
def test_band_table_reproduces_every_row_of_the_matrix(n_in, n_out):
    start, w = _band_table(n_in, n_out)
    dense = np.zeros((n_out, n_in), np.float32)
    np.put_along_axis(dense, start[:, None] + np.arange(w.shape[1]), w, axis=1)
    assert start.dtype == np.int32 and start.min() >= 0 and start.max() + w.shape[1] <= n_in
    assert np.array_equal(dense, _linear_weights(n_in, n_out))
    # the band width follows the scale: the triangle's support is 2 max(scale, 1) wide
    assert w.shape[1] <= int(np.ceil(2 * max(n_in / n_out, 1.0))) + 1


@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
@pytest.mark.parametrize("h,w,size", [(96, 96, 64), (72, 100, 64)], ids=["square", "wide"])
@pytest.mark.parametrize("stage", ["letterbox", "sam"])
def test_preprocess_on_the_cpu_is_the_code_it_replaced(stage, h, w, size, gray):
    images = _frames(h * w + gray, 2, h, w, gray)
    fn, before = ((letterbox_batch, _letterbox_before) if stage == "letterbox"
                  else (sam_preprocess_batch, _sam_before))
    got, r, geo = fn(images, size)
    want, wr, wgeo = before(images, size)
    assert (r, geo) == (wr, wgeo)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("stage", ["letterbox", "sam"])
def test_identity_resize_keeps_the_frame(stage):
    """A frame the size of the resized area is placed as it is: no resample,
    the same values as the dense product's identity."""
    images = _frames(7, 2, 64, 64, gray=True)
    fn, before = ((letterbox_batch, _letterbox_before) if stage == "letterbox"
                  else (sam_preprocess_batch, _sam_before))
    assert torch.equal(fn(images, 64)[0], before(images, 64)[0])


def _resample_as_the_kernel_does(x, hw, size, offset, sub, div, pad):
    """numpy emulation of ``csrc/resample.cu`` over the wrapper's tile plan:
    per canvas tile the vertical pass over the tile's input window (asserted
    within the plan's ``vw`` columns and ``rh`` rows), the horizontal pass,
    then the epilogue and the pad; fp32 sums band by band."""
    b, h, w, c = x.shape
    (nh, nw), (oy, ox) = hw, offset
    cin = c
    ys, wy = _band_table(h, nh)
    xs, wx = _band_table(w, nw)
    ty, tx, vw, rh = _tile_plan(h, nh, w, nw, cin, c, x.itemsize)
    ky, kx = wy.shape[1], wx.shape[1]
    x = x.astype(np.float32)
    out = np.full((b, size, size, c), np.float32(pad), np.float32)
    for cy0 in range(0, size, ty):
        for cx0 in range(0, size, tx):
            r0, r1 = max(cy0, oy) - oy, min(cy0 + ty, size, oy + nh) - oy
            q0, q1 = max(cx0, ox) - ox, min(cx0 + tx, size, ox + nw) - ox
            if r0 >= r1 or q0 >= q1:
                continue
            x0 = xs[q0]
            xw = xs[q1 - 1] + kx - x0
            assert xw <= vw and ys[r1 - 1] + ky - ys[r0] <= rh, (cy0, cx0, xw, vw, rh)
            rows = ys[r0:r1, None] + np.arange(ky)  # (nr, ky) input rows
            win = x[:, rows, x0:x0 + xw]  # (b, nr, ky, xw, c)
            v = np.zeros((b, r1 - r0, xw, c), np.float32)
            for k in range(ky):
                v += wy[r0:r1, k, None, None] * win[:, :, k]
            cols = xs[q0:q1, None] - x0 + np.arange(kx)  # (nq, kx) window columns
            o = np.zeros((b, r1 - r0, q1 - q0, c), np.float32)
            for k in range(kx):
                o += wx[q0:q1, k, None] * v[:, :, cols[:, k]]
            out[:, oy + r0:oy + r1, ox + q0:ox + q1] = (o - np.float32(sub)) / np.float32(div)
    return out


def _float64_resample(x, nh, nw):
    wy = _linear_weights(x.shape[1], nh).astype(np.float64)
    wx = _linear_weights(x.shape[2], nw).astype(np.float64)
    planes = np.moveaxis(x.astype(np.float64), -1, 1)  # (b, c, h, w)
    return np.moveaxis(wy @ planes @ wx.T, 1, -1)


@pytest.mark.parametrize("h,w,size", [(2048, 2048, 640), (2048, 2048, 1024), (512, 512, 640),
                                      (1536, 2048, 640), (100, 333, 96)])
def test_the_kernels_tile_walk_sums_the_bands(h, w, size):
    """The kernel's arithmetic on the CPU at the cells' shapes: one gray
    frame, the letterbox's geometry, raw values (sub 0, div 1): within 5e-4
    of the float64 resample (at most 8 taps of values up to 255 summed in
    fp32 twice), the pad exact."""
    r = min(size / h, size / w)
    nh, nw = round(h * r), round(w * r)
    off = ((size - nh) // 2, (size - nw) // 2)
    x = np.random.default_rng(h + w + size).integers(0, 256, (1, h, w, 1), dtype=np.uint8)
    got = _resample_as_the_kernel_does(x, (nh, nw), size, off, 0.0, 1.0, -1.0)
    want = _float64_resample(x, nh, nw)
    region = got[:, off[0]:off[0] + nh, off[1]:off[1] + nw]
    assert np.abs(region - want).max() <= 5e-4
    mask = np.ones(got.shape, bool)
    mask[:, off[0]:off[0] + nh, off[1]:off[1] + nw] = False
    assert (got[mask] == -1.0).all()


@pytest.mark.parametrize("stage", ["letterbox", "sam"])
def test_kernel_emulation_matches_the_plain_epilogue(stage):
    """The emulated kernel with the stage's epilogue against the plain
    version on a non-square RGB batch: equal pads, the resampled area within
    the fp32 summation order's reach (5e-4 on the 0-255 scale)."""
    x = _frames(11, 2, 60, 90, gray=False)
    if stage == "letterbox":
        hw, off, sub, div = (43, 64), (10, 0), (0.0,) * 3, (255.0,) * 3
        pad = float(np.float32(114.0) / np.float32(255.0))
    else:
        hw, off, sub, div, pad = (43, 64), (0, 0), SAM_MEAN, SAM_STD, 0.0
    want = resample_canvas_plain(x, hw, 64, off, sub, div, pad).numpy()
    got = _resample_as_the_kernel_does(x.numpy(), hw, 64, off, np.array(sub, np.float32),
                                       np.array(div, np.float32), pad)
    inside = np.zeros(got.shape, bool)
    inside[:, off[0]:off[0] + hw[0], off[1]:off[1] + hw[1]] = True
    assert np.array_equal(got[~inside], want[~inside])
    scale = np.array(div, np.float32)
    assert (np.abs(got - want) * scale)[inside].max() <= 5e-4


@pytest.mark.parametrize("n_in,n_out,cin,elem", [(2048, 1024, 1, 1), (2048, 640, 1, 1),
                                                 (2048, 640, 3, 1), (512, 640, 3, 4),
                                                 (4096, 64, 3, 1), (16384, 640, 1, 1)])
def test_tile_plan_fits_the_shared_memory(n_in, n_out, cin, elem):
    ty, tx, vw, rh = _tile_plan(n_in, n_out, n_in, n_out, cin, 3, elem)
    k = _band_table(n_in, n_out)[1].shape[1]
    assert vw >= k and rh >= k
    smem = preprocess._smem_bytes(cin, 3, ty, tx, vw, rh, k, k, elem)
    # under 48 KB, or at the smallest tile under the kernel's opt-in limit
    assert smem <= preprocess.SMEM_PLAIN or ((ty, tx) == (1, 1) and smem <= preprocess.SMEM_MAX)
    if n_in <= 2048 and cin == 1:
        assert (ty, tx) == (16, 64)  # the cells' gray frames keep whole tiles


def test_tile_plan_refuses_windows_past_the_shared_memory():
    """A tile's whole input window sits in shared memory: a downsampling of
    some 200x or more in both directions leaves none that fits."""
    with pytest.raises(ValueError, match="do not fit the kernel's shared memory"):
        _tile_plan(65536, 16, 65536, 16, 1, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_wrapper_refuses_dtypes_it_does_not_take(dtype):
    x = torch.zeros(1, 8, 8, 3, dtype=dtype)
    with pytest.raises(ValueError, match="takes uint8 or fp32 frames"):
        resample_canvas(x, (4, 4), 4, (0, 0), (0.0,) * 3, (1.0,) * 3, 0.0)


def test_wrapper_refuses_areas_off_the_canvas_and_channel_mismatch():
    x = torch.zeros(1, 8, 8, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="leaves the"):
        resample_canvas(x, (4, 4), 4, (1, 0), (0.0,) * 3, (1.0,) * 3, 0.0)
    with pytest.raises(ValueError, match="channels"):
        resample_canvas(x, (4, 4), 4, (0, 0), (0.0,), (1.0,), 0.0)
