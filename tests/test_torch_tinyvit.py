"""The port's MobileSAM (TinyViT-5M) and large-canvas paths against the JAX
package, on the CPU.

The port's numpy init against the JAX one; its plain TinyViT encoder against
``tinyvit_encoder(fused=False)`` at full widths; the plain versions of
K13-K16 against the JAX package's Pallas kernels in interpret mode (as
``tests/test_tinyvit.py`` runs them); the weight bridge; the MobileSAM
pipeline against the JAX one; and, for frames above 512 px, the attention at
windows 48 and 64, the ViT encoder on the 768 and 1024 canvases and the
letterbox from 2048 px. All fp32, inputs from numpy seeds. The CUDA kernels
are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.sam import tinyvit as jtv
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.ops import preprocess as jpre
from yolo_sam_inference_tpu.ops.dw_ln_mlp import dw_ln_mlp as jax_dw_ln_mlp
from yolo_sam_inference_tpu.ops.fused_ln import _ln_rows as jax_ln_rows
from yolo_sam_inference_tpu.ops.mbconv_fused import mbconv_block as jax_mbconv
from yolo_sam_inference_tpu.ops.merge_fused import patch_merge_block as jax_merge
from yolo_sam_inference_tpu.ops.tinyvit_attention import (
    tinyvit_window_block as jax_window_block,
    tinyvit_window_block_cells as jax_window_block_cells,
)
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.models.sam import (
    SamModel,
    TinyViT,
    TinyViTConfig,
    init_sam_params,
    init_tinyvit_params,
    is_tinyvit,
    sam_tiny_test,
)
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops import preprocess
from yolo_sam_inference_tpu_torch.ops.dw_ln_mlp import dw_conv3x3_plain, dw_ln_mlp
from yolo_sam_inference_tpu_torch.ops.flash_attention import (
    window_attention,
    window_attention_plain,
)
from yolo_sam_inference_tpu_torch.models.sam import tinyvit as ttv_model
from yolo_sam_inference_tpu_torch.ops.mbconv_fused import (
    mbconv_block,
    mbconv_plain,
    patch_merge_block,
)
from yolo_sam_inference_tpu_torch.ops.tinyvit_attention import (
    BLOCK_SMEM_BUDGET,
    block_plan,
    block_schedule,
    offset_index,
    qkv_slabs,
    real_query_tiles,
    tinyvit_attention_plain,
    tinyvit_window_block,
    tinyvit_window_block_reference,
)
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.weights import from_jax_params

from test_torch_models import _assert_same_tree, _leaves

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _rand_tinyvit_tree(seed, cfg):
    """Init tree with every zero or one leaf (biases, LN affines, attention
    bias tables) drawn at random: zeros hide padding and bias bugs."""
    tree = init_tinyvit_params(seed, cfg)
    rng = np.random.default_rng(seed + 100)

    def fill(node):
        for key, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif isinstance(v, list):
                for item in v:
                    fill(item)
            elif key == "scale":
                node[key] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            elif key in ("b", "bias", "qkv_b", "proj_b", "mlp1_b", "mlp2_b"):
                node[key] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
            elif key == "attn_bias":
                node[key] = (0.5 * rng.normal(size=v.shape)).astype(np.float32)

    fill(tree)
    return tree


# ------------------------------------------------------------------ TinyViT


@pytest.mark.parametrize("seed", [0, 5])
def test_tinyvit_init_matches_jax_bitwise(seed):
    cfg = TinyViTConfig()
    _assert_same_tree(init_tinyvit_params(seed, cfg),
                      jtv.init_tinyvit_params(seed, jtv.TinyViTConfig()))


def test_offset_index_matches_jax():
    for ws in (3, 7, 14):
        np.testing.assert_array_equal(offset_index(ws), jtv._offset_index(ws))


@pytest.fixture(scope="module")
def tinyvit_tree():
    return _rand_tinyvit_tree(3, TinyViTConfig())


@pytest.mark.parametrize("size", [64, 128])
def test_tinyvit_encoder_matches_jax(tinyvit_tree, size):
    """Full widths at images 64 and 128: stage grids 16/8/8 and 32/16/16
    against windows 7/14/7 pad 16 -> 21, 8 -> 14, 8 -> 14 (and 32 -> 35,
    16 -> 28, 16 -> 21): every window reaches pad tokens."""
    cfg = TinyViTConfig(image_size=size)
    rng = np.random.default_rng(size)
    pix = rng.normal(size=(1, size, size, 3)).astype(np.float32)

    enc = TinyViT(tinyvit_tree, cfg)
    with torch.no_grad():
        got = enc(_t(pix)).numpy()
        plain = enc(_t(pix), plain=True).numpy()
    want = np.asarray(jtv.tinyvit_encoder(tinyvit_tree, _j(pix), jtv.TinyViTConfig(
        image_size=size), fused=False))
    assert got.shape == want.shape == (1, size // 16, size // 16, 256)
    np.testing.assert_array_equal(got, plain)  # the CPU wrappers are the plain versions
    # fp32, ~25 layers in another summation order: 1e-4 of the output range
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _tv_block_args(rng, c, heads, ws):
    return ((0.5 * rng.normal(size=(heads, (2 * ws - 1) ** 2))).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
            (0.5 * rng.normal(size=(c,))).astype(np.float32),
            (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32),
            (0.3 * rng.normal(size=(3 * c,))).astype(np.float32),
            (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32),
            (0.1 * rng.normal(size=(c,))).astype(np.float32))


@pytest.mark.parametrize("b,h,w,c,heads,ws", [(2, 9, 12, 128, 4, 7), (1, 15, 15, 160, 5, 14),
                                              (1, 14, 14, 64, 2, 7)])
def test_tinyvit_window_block_matches_jax_kernels(b, h, w, c, heads, ws):
    """K13: the port's route (LN + qkv on unpadded tokens, pad tokens as keys
    from the one pad-token row, the projection with the residual) against
    both TPU kernel forms in interpret mode and the pad-then-LN reference.
    A large LN bias and qkv bias make the pad keys weigh."""
    rng = np.random.default_rng(h * c + ws)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    table, *args = _tv_block_args(rng, c, heads, ws)
    got = tinyvit_window_block(_t(x), _t(table), *map(_t, args), heads, ws).numpy()
    ref = tinyvit_window_block_reference(_t(x), _t(table), *map(_t, args), heads, ws).numpy()
    bias_tt = _j(table)[:, jtv._offset_index(ws)]
    for kernel in (jax_window_block, jax_window_block_cells):
        want = np.asarray(kernel(_j(x), bias_tt, *map(_j, args), heads, ws, interpret=True))
        # fp32 both sides (the TPU kernel's exp is fp32 on fp32 inputs)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    if h % ws or w % ws:  # the pad keys weigh: a zero pad row gives another result
        qkv = _t(rng.normal(size=(b, h, w, 3 * c)))
        pad = _t(rng.normal(size=(3 * c,)))
        real = tinyvit_attention_plain(qkv, pad, _t(table), heads, ws)
        zero = tinyvit_attention_plain(qkv, torch.zeros(3 * c), _t(table), heads, ws)
        assert (real - zero).abs().max() > 1e-2


def _block_as_the_kernel_computes_it(x, table, ln_s, ln_b, wqkv, bqkv, wproj, bproj, heads,
                                     ws, eps=1e-5):
    """fp32 emulation of csrc/tinyvit_block.cu's plan: the windows in the
    order of block_schedule, each window's tokens zero outside the grid and
    normalised there (no pad-token row), qkv head by head from the
    qkv_slabs rows, the keys of all ws^2 tokens, only the query tiles of
    real_query_tiles, and the projection + residual stored at the window's
    real tokens; every other output stays NaN."""
    b, h, w, c = x.shape
    t, nx, ny = ws * ws, -(-w // ws), -(-h // ws)
    per_item = 2 if ws == 7 else 1  # block_plan's windows in flight
    slabs = qkv_slabs(wqkv)
    idx = torch.from_numpy(offset_index(ws))
    out = torch.full_like(x, float("nan"))
    for walk in block_schedule(b, h, w, ws, per_item, 3)[3]:
        for win in walk:
            wx, wy, bi = win % nx, win // nx % ny, win // (nx * ny)
            rows, cols = min(ws, h - wy * ws), min(ws, w - wx * ws)
            tok = torch.zeros(ws, ws, c)
            tok[:rows, :cols] = x[bi, wy * ws:wy * ws + rows, wx * ws:wx * ws + cols]
            ln = torch.nn.functional.layer_norm(tok.reshape(t, c), (c,), ln_s, ln_b, eps)
            tiles = real_query_tiles(ws, rows, cols)
            o = torch.zeros(t, c)
            for hh in range(heads):
                cols_h = [part * c + hh * 32 + i for part in range(3) for i in range(32)]
                qkv = ln @ slabs[hh * 96:(hh + 1) * 96].T + bqkv[cols_h]
                q, k, v = qkv[:, :32], qkv[:, 32:64], qkv[:, 64:]
                for mt in tiles:
                    r = slice(mt * 64, min(mt * 64 + 64, t))
                    s = q[r] @ k.T * 32 ** -0.5 + table[hh][idx][r]
                    o[r, hh * 32:(hh + 1) * 32] = torch.softmax(s, -1) @ v
            y = o @ wproj + bproj
            for mt in tiles:
                for i in range(mt * 64, min(mt * 64 + 64, t)):
                    ty, tx = divmod(i, ws)
                    if ty < rows and tx < cols:
                        gy, gx = wy * ws + ty, wx * ws + tx
                        out[bi, gy, gx] = x[bi, gy, gx] + y[i]
    return out


@pytest.mark.parametrize("b,h,w,c,heads,ws", [(2, 9, 12, 128, 4, 7), (1, 15, 15, 160, 5, 14),
                                              (1, 14, 14, 128, 4, 7), (3, 5, 6, 320, 10, 7),
                                              (1, 32, 32, 160, 5, 14)])
def test_block_as_the_kernel_plans_it_matches_jax_kernels(b, h, w, c, heads, ws):
    """K13's one-launch plan (zero-pad x, then LN in the window, qkv from the
    kernel's head slabs, pad-only query tiles skipped while their tokens stay
    keys) writes every token of the grid and agrees with both TPU kernel
    forms in interpret mode and with the pad-then-LN reference at 1e-4 (fp32),
    on ragged grids, a grid smaller than one window and the 32 x 32 grid in
    windows of 14 (stage 2: the bottom windows' 3 pad-only tiles)."""
    rng = np.random.default_rng(h * c + ws + b)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    table, *args = _tv_block_args(rng, c, heads, ws)
    got = _block_as_the_kernel_computes_it(_t(x), _t(table), *map(_t, args), heads, ws).numpy()
    assert np.isfinite(got).all()  # every real token written
    ref = tinyvit_window_block_reference(_t(x), _t(table), *map(_t, args), heads, ws).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    bias_tt = _j(table)[:, jtv._offset_index(ws)]
    for kernel in (jax_window_block, jax_window_block_cells):
        want = np.asarray(kernel(_j(x), bias_tt, *map(_j, args), heads, ws, interpret=True))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c,heads,ws,plan", [
    (128, 4, 7, (2, 2, True, 0, 212632)),     # stage 1: all weights resident, 2 windows a block
    (160, 5, 14, (2, 1, False, 3, 226608))])  # stage 2: 2 warpgroups on 1 window, a slab a round
def test_block_plan_fits_the_card(c, heads, ws, plan):
    """The one-launch block's layout (csrc/tinyvit_block.cu ysi_tinyvit_block):
    consumer warpgroups, windows in flight, resident weights, weight slots and
    shared-memory bytes, within the H100's 227 KB at TinyViT-5M's stages 1
    and 2; the bytes add up from the parts its note names, and the slots hold
    a slab's K chunks."""
    got = block_plan(c, heads, ws)
    assert got == plan and got[4] <= BLOCK_SMEM_BUDGET
    nwg, sets, resident, slots, nbytes = got
    t, kch = ws * ws, -(-c // 64)
    own = -(-t // 8) * 8 * 128 + -(-t // 64) * 32 * 128 + 2 * 2 * t * (c + 8)
    own = -(-own // 1024) * 1024
    weights = heads * kch * 96 * 128 + kch * kch * 64 * 128 if resident else slots * 96 * 128
    table = -(-heads * (2 * ws - 1) ** 2 * 4 // 16) * 16
    assert nbytes == 1024 + weights + sets * own + table + 8 * (1 if resident else 2 * slots)
    assert resident or kch <= slots <= 8


@pytest.mark.parametrize("c,heads,ws", [(128, 4, 5), (96, 3, 7), (128, 2, 7), (352, 11, 7),
                                        (320, 10, 14), (128, 4, 14), (320, 10, 7),
                                        (160, 5, 7)])
def test_block_plan_refuses_widths_the_kernel_does_not_take(c, heads, ws):
    """ws off 7 and 14, head dim off 32, or a (ws, C) the kernel is not built
    for (it takes TinyViT-5M's stage 1, (7, 128), and stage 2, (14, 160);
    stage 3, (7, 320), runs on three launches): a ValueError before any
    launch."""
    with pytest.raises(ValueError, match="tinyvit block kernel"):
        block_plan(c, heads, ws)


@pytest.mark.parametrize("b,h,w,ws,sms", [(32, 64, 64, 7, 132), (32, 32, 32, 14, 132),
                                          (32, 32, 32, 7, 132), (3, 9, 12, 7, 4),
                                          (1, 15, 15, 14, 132), (1, 5, 6, 7, 132),
                                          (3, 5, 6, 7, 2)])
def test_block_schedule_writes_every_real_token_once(b, h, w, ws, sms):
    """The persistent grid's window walk: every window taken by exactly one
    consumer warpgroup, at most one block an SM, no block more than one item
    above another; and with the real query tiles, every token of the grid
    written exactly once (a window's pad queries never)."""
    nwg = 2 if ws == 7 else 1
    windows, items, blocks, walks = block_schedule(b, h, w, ws, nwg, sms)
    nx, ny = -(-w // ws), -(-h // ws)
    assert windows == b * nx * ny and items == -(-windows // nwg) and blocks <= sms
    assert sorted(win for walk in walks for win in walk) == list(range(windows))
    per_block = [len(range(k, items, blocks)) for k in range(blocks)]
    assert max(per_block) - min(per_block) <= 1
    count = np.zeros((b, h, w), np.int64)
    for walk in walks:
        for win in walk:
            wx, wy, bi = win % nx, win // nx % ny, win // (nx * ny)
            rows, cols = min(ws, h - wy * ws), min(ws, w - wx * ws)
            for mt in real_query_tiles(ws, rows, cols):
                for i in range(mt * 64, min(mt * 64 + 64, ws * ws)):
                    ty, tx = divmod(i, ws)
                    if ty < rows and tx < cols:
                        count[bi, wy * ws + ty, wx * ws + tx] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("ws", [7, 14])
def test_real_query_tiles_skip_only_pad_only_tiles(ws):
    """The kernel's test of a query tile (its closed form) against the
    tokens themselves, for every window the grid's edge can cut: a tile is
    computed exactly when one of its queries lies in the grid. At stage 2 (32
    x 32 in windows of 14) the bottom windows keep 1 of 4 tiles."""
    t = ws * ws
    for rows in range(1, ws + 1):
        for cols in range(1, ws + 1):
            want = [mt for mt in range(-(-t // 64))
                    if any(i // ws < rows and i % ws < cols
                           for i in range(mt * 64, min(mt * 64 + 64, t)))]
            assert real_query_tiles(ws, rows, cols) == want
            assert want[0] == 0
    if ws == 14:
        assert real_query_tiles(14, 32 - 28, 14) == [0]
        assert real_query_tiles(14, 14, 32 - 28) == [0, 1, 2]


@pytest.mark.parametrize("c,e,co,plan", [
    (64, 128, 128, (3, True, 182032)),   # merge0: weights resident, 3 warpgroups
    (128, 160, 160, (2, True, 211808)),  # merge1: 160 = 2.5 boxes, resident, 2 warpgroups
    (64, 96, 96, (3, True, 182032))])    # E, Co 96: one box and a zero-filled half
def test_s2_plan_fits_the_card(c, e, co, plan):
    """The stride-2 merge's layout (csrc/mbconv.cu ysi_patch_merge) within the
    H100's 227 KB at merge0 and merge1, in both compute modes (the mode is a
    runtime flag of the same layout); E and Co count in 64-channel boxes, a
    warpgroup holds its 17 x 17 chunk tile (the expansion reads x from device
    memory), rounded up to 16 bytes so the next warpgroup's rows stay
    16-byte aligned."""
    from yolo_sam_inference_tpu_torch.ops.mbconv_fused import S1_SMEM_BUDGET, s2_plan

    wgs, resident, nbytes = s2_plan(c, e, co)
    assert (wgs, resident, nbytes) == plan
    assert nbytes <= S1_SMEM_BUDGET
    ep, cop = -(-e // 64) * 64, -(-co // 64) * 64
    weights = 2 * (c * ep + ep * cop)
    own = -(-2 * 289 * 76 // 16) * 16
    assert nbytes == 1024 + weights + wgs * own + 16 * wgs


@pytest.mark.parametrize("c,e,co", [(40, 128, 128), (64, 100, 128), (64, 128, 352),
                                    (272, 128, 128), (256, 320, 320), (160, 320, 320)])
def test_s2_plan_refuses_widths_the_kernel_does_not_take(c, e, co):
    """C other than merge0's 64 and merge1's 128 (the widths compiled in), Co
    off its merge's range, E or Co off a multiple of 32: a ValueError before
    any launch."""
    from yolo_sam_inference_tpu_torch.ops.mbconv_fused import s2_plan

    with pytest.raises(ValueError, match="stride-2 merge kernel"):
        s2_plan(c, e, co)


@pytest.mark.parametrize("shape,wgs,sms", [((32, 128, 128), 3, 132), ((32, 64, 64), 2, 132),
                                           ((1, 18, 22), 3, 132), ((3, 14, 30), 2, 4)])
def test_s2_schedule_writes_every_output_pixel_once(shape, wgs, sms):
    """The stride-2 tile walk over the (H / 2, W / 2) output grid: every
    output pixel (the last row and column of 8 x 8 tiles ragged where 8 does
    not divide) written by exactly one warpgroup, at most one block an SM,
    no warpgroup more than one tile above any other."""
    from yolo_sam_inference_tpu_torch.ops.mbconv_fused import s2_schedule

    b, h, w = shape
    ho, wo = h // 2, w // 2
    tiles, blocks, walks = s2_schedule(b, h, w, wgs, sms)
    tx, ty = -(-wo // 8), -(-ho // 8)
    assert tiles == b * tx * ty and blocks <= sms
    count = np.zeros((b, ho, wo), np.int64)
    for walk in walks:
        for i in walk:
            bi, oy0, ox0 = i // (tx * ty), i // tx % ty * 8, i % tx * 8
            count[bi, oy0:oy0 + 8, ox0:ox0 + 8] += 1
    assert (count == 1).all()
    counts = [len(walk) for walk in walks]
    assert max(counts) - min(counts) <= 1


def _conv_weights(rng, c, e, co):
    return ((rng.normal(size=(c, e)) / np.sqrt(c)).astype(np.float32),
            (0.3 * rng.normal(size=(e,))).astype(np.float32),
            (rng.normal(size=(3, 3, 1, e)) / 3).astype(np.float32),
            (0.3 * rng.normal(size=(e,))).astype(np.float32),
            (rng.normal(size=(e, co)) / np.sqrt(e)).astype(np.float32),
            (0.3 * rng.normal(size=(co,))).astype(np.float32))


# The TPU kernels' GELU uses a rational erf with a fast reciprocal (within
# 9.3e-5 of exact erf per element, tests/test_tinyvit.py:143-145); the
# port's plain versions use torch.erf: the bound of tests/test_tinyvit.py.
_ERF_ATOL = 3e-4


@pytest.mark.parametrize("c,e,co,plan", [
    (64, 256, 64, (4, True, 181824)),     # stage 0: all weights resident, 4 warpgroups
    (160, 320, 320, (2, False, 219936)),  # merge2: 300 KB of weights, streamed by chunk
    (128, 256, 128, (2, False, 149792)),  # Co of two boxes: streamed
    (32, 128, 64, (4, True, 115264))])
def test_s1_plan_fits_the_card(c, e, co, plan):
    """The stride-1 kernel's layout (csrc/mbconv.cu ysi_mbconv_s1): warpgroups
    a block, resident weights, shared-memory bytes, within the H100's 227 KB
    opt-in limit; the bytes add up from the parts its note names."""
    from yolo_sam_inference_tpu_torch.ops.mbconv_fused import S1_SMEM_BUDGET, s1_plan

    wgs, resident, nbytes = s1_plan(c, e, co)
    assert (wgs, resident, nbytes) == plan
    assert nbytes <= S1_SMEM_BUDGET
    weights = 2 * (c * e + e * co) if resident else wgs * 2 * (64 * c + 64 * co)
    assert nbytes == 1024 + weights + wgs * 2 * 100 * ((c + 8) + 72) + 16 * wgs


@pytest.mark.parametrize("c,e,co", [(48, 192, 48), (72, 256, 64), (64, 96, 64),
                                    (64, 256, 384), (256, 320, 320)])
def test_s1_plan_refuses_widths_the_kernel_does_not_take(c, e, co):
    """C off a multiple of 16, E or Co off a multiple of 64, Co above 320, or
    a layout above the card's shared memory: a ValueError before any launch."""
    from yolo_sam_inference_tpu_torch.ops.mbconv_fused import s1_plan

    with pytest.raises(ValueError, match="stride-1 MBConv kernel"):
        s1_plan(c, e, co)


def test_kernel_erf_fit_is_fp32_erf():
    """The stride-1 kernel's branch-free erf (csrc/mbconv.cu erf_fit), evaluated
    in fp32 as the kernel does (with an exact 2^), stays within 2e-7 of erf
    over [-12, 12] (about 3 ulp; CUDA's erff is within 2), so its GELUs round
    to bf16 as erf's do; and the source carries the coefficients ERF_FIT
    holds."""
    import math
    import re
    from pathlib import Path

    from yolo_sam_inference_tpu_torch.ops import mbconv_fused as mb

    x = np.linspace(-12, 12, 400001).astype(np.float32)
    want = np.array([math.erf(v) for v in x.astype(np.float64)])
    err = np.abs(mb.erf_fit(x).astype(np.float64) - want)
    assert err.max() <= 2e-7, (err.max(), x[err.argmax()])
    src = (Path(mb.__file__).parent.parent / "csrc" / "mbconv.cu").read_text()
    body = src[src.index("float erf_fit("):src.index("float gelu(")]
    coeffs = [float(v) for v in re.findall(r"([-+]?\d\.\d+e[-+]\d+)f", body)]
    assert coeffs == [*mb.ERF_FIT["P"], *mb.ERF_FIT["Q"]]


@pytest.mark.parametrize("shape,wgs,sms", [((32, 128, 128), 4, 132), ((32, 32, 32), 2, 132),
                                           ((1, 13, 21), 4, 132), ((3, 9, 11), 2, 4)])
def test_s1_schedule_takes_every_tile_once(shape, wgs, sms):
    """The persistent grid's tile walk: every 8 x 8 output tile (the last row
    and column of tiles ragged where 8 does not divide H or W) is taken by
    exactly one warpgroup, at most one block an SM, and no warpgroup takes
    more than one tile above any other."""
    from yolo_sam_inference_tpu_torch.ops.mbconv_fused import s1_schedule

    b, h, w = shape
    tiles, blocks, walks = s1_schedule(b, h, w, wgs, sms)
    assert tiles == b * -(-h // 8) * -(-w // 8)
    assert blocks <= sms and blocks * wgs >= min(tiles, sms * wgs)
    assert sorted(i for walk in walks for i in walk) == list(range(tiles))
    counts = [len(walk) for walk in walks]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("residual,c,co", [(True, 64, 64), (False, 160, 320)])
def test_mbconv_matches_jax_kernel(residual, c, co):
    """K14: stage 0's MBConv and the stride-1 merge2 (no residual), with
    biases that make gelu(b1) != 0 on the padding."""
    rng = np.random.default_rng(c)
    e = 4 * c if residual else co
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    w = _conv_weights(rng, c, e, co)
    got = mbconv_block(_t(x), *map(_t, w), residual=residual).numpy()
    want = np.asarray(jax_mbconv(_j(x), *map(_j, w), interpret=True, residual=residual))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=_ERF_ATOL)


@pytest.mark.parametrize("shape,co", [((2, 6, 16, 64), 128), ((1, 18, 32, 128), 160)])
def test_patch_merge_matches_jax_kernel(shape, co):
    """K15 at an odd number of row strips (3 strips of 1 and of 3 quarter
    rows): only the top and left padding of the stride-2 depthwise exists."""
    rng = np.random.default_rng(co)
    x = rng.normal(size=shape).astype(np.float32)
    w = _conv_weights(rng, shape[-1], co, co)
    got = patch_merge_block(_t(x), *map(_t, w)).numpy()
    want = np.asarray(jax_merge(_j(x), *map(_j, w), interpret=True))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, co)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=_ERF_ATOL)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


@pytest.mark.parametrize("stride,residual,shape,e,co", [(1, True, (2, 16, 16, 64), 256, 64),
                                                        (1, False, (2, 16, 16, 160), 320, 320),
                                                        (2, False, (2, 32, 32, 64), 128, 128)])
def test_bf16_compute_matches_jax_kernels(stride, residual, shape, e, co):
    """K14 (stage 0's MBConv, merge2) and K15 (merge0) with compute="bf16"
    on bf16 inputs and weights: the port's plain version against the TPU
    kernel's bf16 mode in interpret mode and against the fp32 plain version,
    at the JAX package's bound for the mode (tests/test_tinyvit.py:250-281:
    max <= 0.08 and mean <= 0.01 of max|ref|); and the mode changes the
    result (it rounds where the fp32 mode does not)."""
    rng = np.random.default_rng(shape[-1] + e)
    x = _bf16(rng.normal(size=shape))
    w = [_bf16(a) for a in _conv_weights(rng, shape[-1], e, co)]
    if stride == 2:
        got = patch_merge_block(x, *w, compute="bf16")
        got32 = patch_merge_block(x, *w)
        want = jax_merge(_j(x.float()).astype(jnp.bfloat16),
                         *(_j(a.float()).astype(jnp.bfloat16) for a in w), interpret=True,
                         compute="bf16")
    else:
        got = mbconv_block(x, *w, residual=residual, compute="bf16")
        got32 = mbconv_block(x, *w, residual=residual)
        want = jax_mbconv(_j(x.float()).astype(jnp.bfloat16),
                          *(_j(a.float()).astype(jnp.bfloat16) for a in w), interpret=True,
                          residual=residual, compute="bf16")
    assert got.dtype == torch.bfloat16
    ref = mbconv_plain(x.float(), *w, stride=stride, residual=residual).numpy()
    scale = np.abs(ref).max()
    for other in (np.asarray(want).astype(np.float32), ref):
        err = np.abs(got.float().numpy() - other)
        assert err.max() <= 0.08 * scale and err.mean() <= 0.01 * scale, (err.max(), scale)
    assert not torch.equal(got, got32)


@pytest.mark.parametrize("c", [128, 160, 320])  # TinyViT-5M's three block widths
def test_dw_ln_mlp_matches_jax_kernel(c):
    """K16: y = dw3x3(x) + b; y + mlp(LN(y)) -- the residual is y, not x. The
    port's composition (the depthwise writing y and LN(y), then the MLP on
    LN(y)) against the interpret-mode TPU kernel."""
    rng = np.random.default_rng(16)
    x = rng.normal(size=(2, 16, 16, c)).astype(np.float32)
    wd = (rng.normal(size=(3, 3, 1, c)) / 3).astype(np.float32)
    bd = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    s, b = (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32), (0.1 * rng.normal(
        size=(c,))).astype(np.float32)
    w1, b1 = (rng.normal(size=(c, 4 * c)) / np.sqrt(c)).astype(np.float32), (0.1 * rng.normal(
        size=(4 * c,))).astype(np.float32)
    w2, b2 = (rng.normal(size=(4 * c, c)) / np.sqrt(4 * c)).astype(np.float32), (
        0.1 * rng.normal(size=(c,))).astype(np.float32)
    args = (wd, bd, s, b, w1, b1, w2, b2)
    got = dw_ln_mlp(_t(x), *map(_t, args)).numpy()
    want = np.asarray(jax_dw_ln_mlp(_j(x), *map(_j, args), eps=1e-5, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=_ERF_ATOL)


def test_dw_conv3x3_plain_with_ln_returns_y_and_its_layer_norm():
    """``dw_conv3x3_plain(..., ln=)``: y exactly as without ``ln``, and LN(y)
    as the TPU kernel's ``_ln_rows`` computes it on that y (fp32: within
    1e-5 of its O(1) outputs, summation order aside)."""
    rng = np.random.default_rng(8)
    c = 160
    x = rng.normal(size=(2, 9, 11, c)).astype(np.float32)
    wd = (rng.normal(size=(3, 3, c)) / 3).astype(np.float32)
    bd = (0.3 * rng.normal(size=(c,))).astype(np.float32)
    s = (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32)
    sh = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    y_old = dw_conv3x3_plain(_t(x), _t(wd), _t(bd))
    y, ln_y = dw_conv3x3_plain(_t(x), _t(wd), _t(bd), ln=(_t(s), _t(sh), 1e-5))
    assert torch.equal(y, y_old)
    want = np.asarray(jax_ln_rows(_j(y.numpy().reshape(-1, c)), _j(s), _j(sh), 1e-5))
    np.testing.assert_allclose(ln_y.numpy().reshape(-1, c), want, rtol=0, atol=1e-5)


def test_bridge_builds_tinyvit(tinyvit_tree):
    """from_jax_params on a tree with "tinyvit" and no "vision": the module's
    parameters are the tree's leaves (1x1 convs as (in, out) matrices,
    depthwise as (3, 3, C), stems and the neck's 3x3 as OIHW)."""
    cfg = sam_tiny_test()
    tree = dict(init_sam_params(1, cfg))
    tree.pop("vision")
    tree["tinyvit"] = tinyvit_tree
    _, sam = from_jax_params(None, tree, "cpu", torch.float32, sam_config=cfg)
    tv = sam.vision
    leaves = dict(_leaves(tinyvit_tree))
    pairs = {
        "/stem1/w": (tv.stem1_w, (3, 2, 0, 1)), "/neck/conv2_w": (tv.neck_conv2, (3, 2, 0, 1)),
        "/stage0/1/conv1/w": (tv.stage0[1].w1, None), "/merge1/conv2/w": (tv.merge1.wd, None),
        "/stage2/3/attn/attn_bias": (tv.stages[1][3].attn_bias, None),
        "/stage3/1/local_conv/w": (tv.stages[2][1].local_w, None),
        "/stage1/0/mlp2_w": (tv.stages[0][0].mlp2_w, None),
        "/neck/ln2/bias": (tv.neck_ln2_bias, None),
    }
    for path, (param, perm) in pairs.items():
        want = leaves[path]
        if perm is not None:
            want = want.transpose(perm)
        elif want.ndim == 4 and want.shape[:2] == (1, 1):
            want = want[0, 0]
        np.testing.assert_array_equal(param.numpy(), want.reshape(param.shape), err_msg=path)
    n_leaves = sum(np.size(v) for _, v in _leaves(tinyvit_tree))
    assert sum(p.numel() for p in tv.parameters()) == n_leaves
    _, sam16 = from_jax_params(None, tree, "cpu", torch.bfloat16, sam_config=cfg)
    assert all(p.dtype == torch.bfloat16 for p in sam16.vision.parameters())


# ------------------------------------------------------------ MobileSAM slice

MOBILE_OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=32,
                   sam_encoder_size=64)


@pytest.fixture(scope="module")
def mobile_both():
    """Both MobileSAM pipelines (test_tinyvit.py:382-390's configuration)."""
    rng = np.random.default_rng(0)
    frames = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    jp = jengine.CellSegmentationPipeline(
        sam_model_type="mobile-sam", sam_config=dataclasses.replace(
            jax_tiny(), image_size=64, patch_size=16),
        yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **MOBILE_OPTS))
    tp = tengine.CellSegmentationPipeline(
        sam_model_type="mobile-sam", device="cpu", sam_config=dataclasses.replace(
            sam_tiny_test(), image_size=64, patch_size=16),
        yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **MOBILE_OPTS))
    return frames, jp, tp, jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)


def test_mobile_sam_params_match_jax(mobile_both):
    _, jp, tp, _, _ = mobile_both
    assert is_tinyvit(tp.sam_params)
    _assert_same_tree(tp.sam_params, jp.sam_params)


def test_mobile_sam_slice_matches_jax(mobile_both):
    """Embeddings to fp32 rounding; detections exactly; mask crops on >= 99.5%
    of pixels and the metrics of identical masks, as the config-1 slice test."""
    frames, jp, tp, jo, to = mobile_both
    h, w = frames.shape[1:3]
    img = torch.from_numpy(frames)
    with torch.inference_mode():
        emb = tp._stages(h, w)["embed"](img).numpy()
    jst = jp._stages(h, w)
    jemb = np.asarray(jst["embed"](jst["sam_params"], jnp.asarray(frames)))
    assert emb.shape == jemb.shape == (2, 4, 4, 16)
    np.testing.assert_allclose(emb, jemb, rtol=0, atol=1e-4 * np.abs(jemb).max())
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    agree = to["mask_crops"] == jo["mask_crops"]
    assert agree.mean() >= 0.995, agree.mean()
    same = agree.all(axis=(2, 3)) & jo["valid"]
    for key, want in jo["metrics"].items():
        np.testing.assert_allclose(to["metrics"][key][same], want[same], rtol=1e-4, atol=1e-3,
                                   err_msg=key)


@pytest.mark.parametrize("mobile", [False, True])
def test_sam_model_picks_its_encoder_from_the_tree(tinyvit_tree, mobile):
    """One rule, ``is_tinyvit``: a "tinyvit" subtree and no "vision" one
    builds TinyViT; a tree that keeps "vision" builds the ViT, whatever else
    it holds."""
    cfg = dataclasses.replace(sam_tiny_test(), image_size=64, patch_size=16)
    tree = dict(init_sam_params(1, cfg), tinyvit=tinyvit_tree)
    if mobile:
        tree.pop("vision")
    assert is_tinyvit(tree) == mobile
    assert isinstance(SamModel(tree, cfg).vision, TinyViT) == mobile


# ------------------------------------------------- frames above 512 px (repair)


@pytest.mark.parametrize("window", [48, 64])
def test_window_attention_at_48_and_64_matches_jax(window):
    """The global attention of the 768 and 1024 canvases against the JAX CPU
    path (``_vision_attention``: q-scaled logits, unscaled-q rel-pos bias),
    one window of window x window tokens, 2 heads of 8."""
    heads, hd = 2, 8
    c = heads * hd
    rng = np.random.default_rng(window)
    x = rng.normal(size=(1, window, window, c)).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    bqkv = (0.1 * rng.normal(size=(3 * c,))).astype(np.float32)
    rel = [(0.3 * rng.normal(size=(2 * window - 1, hd))).astype(np.float32) for _ in range(2)]
    wproj = np.eye(c, dtype=np.float32)
    qkv = _t(x) @ _t(wqkv) + _t(bqkv)
    got = window_attention(qkv, _t(rel[0]), _t(rel[1]), heads, window).numpy()
    p = {"qkv": {"w": _j(wqkv), "b": _j(bqkv)}, "proj": {"w": _j(wproj), "b": _j(np.zeros(c))},
         "rel_pos_h": _j(rel[0]), "rel_pos_w": _j(rel[1])}
    want = np.asarray(jsam._vision_attention(p, _j(x), heads, True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)  # fp32, another order


def test_window_attention_plain_slices_large_batches(monkeypatch):
    """The plain version runs big batches in slices of images: same result."""
    from yolo_sam_inference_tpu_torch.ops import flash_attention as tfa

    rng = np.random.default_rng(3)
    qkv = _t(rng.normal(size=(3, 8, 8, 3 * 16)))
    rel = _t(0.3 * rng.normal(size=(15, 8)))
    whole = window_attention_plain(qkv, rel, rel, 2, 8)
    monkeypatch.setattr(tfa, "_PLAIN_LOGIT_BYTES", 2 * 8 * 8 * 64 * 4)  # one image a slice
    torch.testing.assert_close(window_attention_plain(qkv, rel, rel, 2, 8), whole,
                               rtol=0, atol=0)


@pytest.mark.parametrize("canvas", [768, 1024])
def test_vit_encoder_on_large_canvases_matches_jax(canvas):
    """A tiny ViT (patch 16, 2 layers, the second global) on the 768 and 1024
    canvases as the engine sets them up: windows 16 and 48 / 64."""
    cfg = dataclasses.replace(sam_tiny_test(), image_size=canvas, patch_size=16, window_size=16,
                              vision_hidden=16, vision_heads=2, vision_mlp_dim=32,
                              output_channels=8)
    tree = init_sam_params(2, cfg)
    rng = np.random.default_rng(canvas)
    for lp in tree["vision"]["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = (0.3 * rng.normal(size=lp["attn"][key].shape)).astype(np.float32)
    pix = rng.normal(size=(1, canvas, canvas, 3)).astype(np.float32)
    with torch.no_grad():
        got = SamModel(tree, cfg).vision(_t(pix)).numpy()
    want = np.asarray(jsam.sam_image_encoder(tree, _j(pix), cfg))
    assert got.shape == want.shape == (1, canvas // 16, canvas // 16, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_letterbox_from_2048_matches_jax():
    """Config 4's frames: 2048 x 2048 down to the 640 YOLO canvas."""
    rng = np.random.default_rng(2048)
    img = rng.integers(0, 256, size=(1, 2048, 2048, 3), dtype=np.uint8)
    got, r, pad = preprocess.letterbox_batch(torch.from_numpy(img), 640)
    want, jr, jpad = jpre.letterbox_batch(jnp.asarray(img), 640)
    assert r == jr and pad == jpad and got.shape == (1, 640, 640, 3)
    # the antialiased triangle filter over a 3.2x downsample, fp32 sums
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tinyvit_bf16_mbconv_compute_matches_jax(tinyvit_tree, monkeypatch):
    """TinyViT in bf16 with ``mbconv_compute="bf16"`` on bf16 pixels (image
    128) against JAX ``tinyvit_encoder(fused=True, interpret=True,
    mbconv_compute="bf16")`` on the same bf16-rounded tree. The mode reaches
    K14 and K15 under JAX's gates: the stage-0 MBConvs and merge2, not the
    stride-2 merges below 128 rows. Both sides run ~25 layers in bf16,
    rounding at other places (GELU arithmetic, attention, LayerNorms): within
    3% relative RMS (the port's fp32-compute mode is 1.3% from JAX's)."""
    size = 128
    tree = jax.tree.map(lambda a: _bf16(a).float().numpy(), tinyvit_tree)
    pix = _bf16(np.random.default_rng(size).normal(size=(1, size, size, 3)))
    modes = []
    for name in ("mbconv_block", "patch_merge_block"):
        real = getattr(ttv_model, name)

        def spy(*a, _real=real, _name=name, **k):
            modes.append((_name, k.get("compute")))
            return _real(*a, **k)

        monkeypatch.setattr(ttv_model, name, spy)
    enc = TinyViT(tree, TinyViTConfig(image_size=size), mbconv_compute="bf16").to(torch.bfloat16)
    with torch.no_grad():
        got = enc(pix).float().numpy()
    assert modes == [("mbconv_block", "bf16")] * 2 + [("patch_merge_block", "fp32")] * 2 + [
        ("mbconv_block", "bf16")]
    jt = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)
    want = np.asarray(jtv.tinyvit_encoder(
        jt, _j(pix.float()).astype(jnp.bfloat16), jtv.TinyViTConfig(image_size=size),
        mbconv_compute="bf16", fused=True, interpret=True)).astype(np.float32)
    assert got.shape == want.shape == (1, size // 16, size // 16, 256)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 0.03


def test_mbconv_compute_refuses_unknown_modes(tinyvit_tree):
    x = torch.zeros(1, 8, 8, 64)
    w = [torch.zeros(64, 256), torch.zeros(256), torch.zeros(3, 3, 256), torch.zeros(256),
         torch.zeros(256, 64), torch.zeros(64)]
    with pytest.raises(ValueError, match="compute must be one of"):
        mbconv_block(x, *w, compute="fp16")
    with pytest.raises(ValueError, match="compute must be one of"):
        patch_merge_block(x, *w, compute="int8")
    with pytest.raises(ValueError, match="mbconv_compute must be one of"):
        TinyViT(tinyvit_tree, TinyViTConfig(image_size=64), mbconv_compute="bfloat16")
    with pytest.raises(ValueError, match="tinyvit_mbconv_compute must be one of"):
        tengine.CellSegmentationPipeline(
            sam_model_type="mobile-sam", device="cpu", sam_config=sam_tiny_test(),
            options=tengine.PipelineOptions(tinyvit_mbconv_compute="fp16"))
