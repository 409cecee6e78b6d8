"""The port's K8 and K9 plain versions against the JAX package, on the CPU,
and a CPU emulation of K9's kernel against its plain version.

On the CPU ``hull_support`` and ``window_crop`` take their plain PyTorch
versions: the masks-form hull support (the candidates, then the selection)
is held against JAX's ``_hull_candidate_scores`` followed by the Pallas
``support_vertices_tpu`` in interpret mode, and the crop, fed the engine's
(N, 2) int64 starts as two strided columns, against the Pallas
``window_crop`` on the clipped int32 starts. ``csrc/hull_support.cu`` leaves
the centroid candidates out and breaks score ties with one packed key;
``_hull_support_as_the_kernel_does`` repeats that in numpy so the CPU can
hold the method to the plain version; ``_hull_support_as_the_frames_kernels_do``
does the same for the kernels that take masks with a side above 256 (whole
frames). The CUDA kernels themselves are held
to the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_sam_inference_tpu.ops.hull_support import support_vertices_tpu
from yolo_sam_inference_tpu.ops.metrics import _hull_candidate_scores
from yolo_sam_inference_tpu.ops.window_crop import window_crop as j_window_crop
from yolo_sam_inference_tpu_torch.ops.hull_support import (
    CHUNK,
    GROUP,
    TILE,
    frame_plan,
    hull_candidates,
    hull_support,
    hull_support_plain,
)
from yolo_sam_inference_tpu_torch.ops.metrics import _hull_directions
from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop

torch.set_num_threads(1)

SIZES = (64, 128, 256)
CASES = ("empty", "one pixel", "full", "four edges", "blob")


def _mask(case: str, size: int) -> np.ndarray:
    """A (size, size) bool crop: empty, one pixel, full, an ellipse touching
    all four edges, or a random blob (three overlapping ellipses, some off
    the crop)."""
    yy, xx = np.mgrid[:size, :size]
    m = np.zeros((size, size), bool)
    if case == "one pixel":
        m[size // 3, size // 2] = True
    elif case == "full":
        m[:] = True
    elif case == "four edges":
        c = (size - 1) / 2
        m = ((yy - c) / (size / 2)) ** 2 + ((xx - c) / (size / 2)) ** 2 <= 1.0
    elif case == "blob":
        rng = np.random.default_rng(size)
        for _ in range(3):
            cy, cx = rng.uniform(0.1 * size, 0.9 * size, 2)
            ry, rx = rng.uniform(0.05 * size, 0.4 * size, 2)
            m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    return m


def _jax_hull(masks: np.ndarray, dirs: np.ndarray):
    pts, _, any_mask = _hull_candidate_scores(jnp.asarray(masks), dirs.shape[0])
    sup = support_vertices_tpu(jnp.transpose(pts, (0, 2, 1)), jnp.asarray(dirs), interpret=True)
    return np.asarray(sup).transpose(0, 2, 1), np.asarray(any_mask)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_hull_support_plain_matches_jax(case, size):
    """K9 from the masks: the support point per direction and the non-empty
    flag. Equal points, except where the two sides' fp32 scores order
    candidates whose exact scores tie (JAX's contraction rounds otherwise
    than two products and a sum): there both points are maximisers of the
    exact score (coordinates are half-integers, so the float64 scores of the
    fp32 directions are exact) and lie on the same supporting line."""
    dirs = _hull_directions(256)
    masks = _mask(case, size)[None]
    got, got_any = hull_support(torch.from_numpy(masks), torch.from_numpy(dirs))
    want, want_any = _jax_hull(masks, dirs)
    np.testing.assert_array_equal(got_any.numpy(), want_any)
    got = got.numpy()
    score = lambda p: (p.astype(np.float64) * dirs.astype(np.float64)).sum(-1)
    differ = (got != want).any(-1)
    np.testing.assert_array_equal(score(got)[differ], score(want)[differ])
    assert differ.mean() <= 0.05, differ.mean()
    if case in ("empty", "full", "one pixel"):  # no ties that rounding could decide
        np.testing.assert_array_equal(got, want)
    if case == "empty":  # every point the centroid of nothing, as JAX gives it
        assert not got.any() and not got_any.any()


def _hull_support_as_the_kernel_does(masks: np.ndarray, dirs: np.ndarray):
    """``hull_support_kernel``'s method in numpy: the candidates of the rows
    and columns with a pixel only (no centroid), each score two fp32
    products and an fp32 sum, ties broken by the packed integer key
    (2r + 1) * 2^13 + (2c + 1); an empty mask's points all (0, 0)."""
    n, h, w = masks.shape
    out = np.zeros((n, dirs.shape[0], 2), np.float32)
    for i, m in enumerate(masks):
        rows, cols = np.nonzero(m.any(1))[0], np.nonzero(m.any(0))[0]
        if not len(rows):
            continue
        minc = np.array([np.nonzero(m[r])[0][0] for r in rows])
        maxc = np.array([np.nonzero(m[r])[0][-1] for r in rows])
        minr = np.array([np.nonzero(m[:, c])[0][0] for c in cols])
        maxr = np.array([np.nonzero(m[:, c])[0][-1] for c in cols])
        r = np.concatenate([rows, rows, minr - 0.5, maxr + 0.5]).astype(np.float32)
        c = np.concatenate([minc - 0.5, maxc + 0.5, cols, cols]).astype(np.float32)
        key = (2 * r + 1).astype(np.int64) * 2 ** 13 + (2 * c + 1).astype(np.int64)
        assert key.max() < 2 ** 31  # an int32
        s = r[:, None] * dirs[:, 0] + c[:, None] * dirs[:, 1]  # fp32, each op rounded
        best = np.lexsort((key[:, None].repeat(len(dirs), 1), s), axis=0)[-1]
        out[i, :, 0], out[i, :, 1] = r[best], c[best]
    return out


@pytest.mark.parametrize("size", SIZES)
def test_kernel_method_equals_the_plain_version(size):
    """What the kernel leaves out (the centroid of empty rows and columns)
    never wins, and its packed key breaks ties as the plain version's two
    masked maxima: the edge cases and 8 random ellipses, some touching the
    crop's edges, equal bit for bit."""
    rng = np.random.default_rng(size + 1)
    yy, xx = np.mgrid[:size, :size]
    cy, cx = (rng.uniform(0.2 * size, 0.8 * size, (8, 1, 1)) for _ in range(2))
    ry, rx = (rng.uniform(0.02 * size, 0.5 * size, (8, 1, 1)) for _ in range(2))
    masks = np.concatenate([np.stack([_mask(case, size) for case in CASES]),
                            ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0])
    dirs = _hull_directions(256)
    want, _ = hull_support_plain(torch.from_numpy(masks), torch.from_numpy(dirs))
    np.testing.assert_array_equal(_hull_support_as_the_kernel_does(masks, dirs), want.numpy())


def _first_last(t: np.ndarray):
    """Each row's first and last set column of a bool (r, c) array, and
    whether it has one."""
    ok = t.any(1)
    return t.argmax(1), t.shape[1] - 1 - t[:, ::-1].argmax(1), ok


def _hull_support_as_the_frames_kernels_do(masks: np.ndarray, dirs: np.ndarray, sms: int):
    """The frames' kernels' method in numpy: the extremes merged tile by
    tile as maxima of (w - minc, maxc + 1) a row and (h - minr, maxr + 1) a
    column (0: no pixel); the candidates of each slice of :func:`frame_plan`
    (CHUNK rows and columns a chunk) with their 64-bit keys (2r + 1) * 2^32 +
    (2c + 1), each slice's best (score, key) a direction, merged over the
    slices; the point decoded from the key; an empty mask's points (0, 0)."""
    n, h, w = masks.shape
    d = dirs.shape[0]
    slices, per = frame_plan(n, h, w, d, sms)
    out = np.zeros((n, d, 2), np.float32)
    flags = np.zeros(n, bool)
    for i, m in enumerate(masks):
        ext = np.zeros((4, max(h, w)), np.int64)  # row_lo, row_hi, col_lo, col_hi
        for r0 in range(0, h, TILE):
            for c0 in range(0, w, TILE):
                t = m[r0:r0 + TILE, c0:c0 + TILE]
                for k, (tt, o_own, o_other, side) in enumerate(((t, r0, c0, w), (t.T, c0, r0, h))):
                    first, last, ok = _first_last(tt)
                    idx = o_own + np.nonzero(ok)[0]
                    ext[2 * k, idx] = np.maximum(ext[2 * k, idx], side - (o_other + first[ok]))
                    ext[2 * k + 1, idx] = np.maximum(ext[2 * k + 1, idx], o_other + last[ok] + 1)
        best_s = np.full(d, -np.inf, np.float32)
        best_k = np.zeros(d, np.uint64)
        for s in range(slices):
            idx = np.arange(s * per * CHUNK, min(max(h, w), (s + 1) * per * CHUNK))
            r_ok, c_ok = idx[idx < h][ext[1, idx[idx < h]] > 0], idx[idx < w][ext[3, idx[idx < w]] > 0]
            r2 = np.concatenate([2 * r_ok + 1, 2 * r_ok + 1, 2 * (h - ext[2, c_ok]),
                                 2 * (ext[3, c_ok] - 1) + 2])
            c2 = np.concatenate([2 * (w - ext[0, r_ok]), 2 * (ext[1, r_ok] - 1) + 2, 2 * c_ok + 1,
                                 2 * c_ok + 1])
            if not len(r2):
                continue
            key = r2.astype(np.uint64) << np.uint64(32) | c2.astype(np.uint64)
            r = (r2 - 1).astype(np.float32) * np.float32(0.5)
            c = (c2 - 1).astype(np.float32) * np.float32(0.5)
            sc = r[:, None] * dirs[:, 0] + c[:, None] * dirs[:, 1]  # fp32, each op rounded
            top = np.lexsort((key[:, None].repeat(d, 1), sc), axis=0)[-1]
            s_top, k_top = sc[top, np.arange(d)], key[top]
            take = (s_top > best_s) | ((s_top == best_s) & (k_top > best_k))
            best_s, best_k = np.where(take, s_top, best_s), np.where(take, k_top, best_k)
        flags[i] = best_k[0] != 0
        if flags[i]:
            out[i, :, 0] = ((best_k >> np.uint64(32)).astype(np.int64) - 1) * 0.5
            out[i, :, 1] = ((best_k & np.uint64(0xFFFFFFFF)).astype(np.int64) - 1) * 0.5
    return out, flags


@pytest.mark.parametrize("h,w", [(300, 258), (37, 700), (1, 1000), (1000, 3), (520, 777)])
def test_frames_kernels_method_equals_the_plain_version(h, w):
    """Masks with a side above TILE take the frames' kernels: their method
    (tile-merged extremes, the slices' candidates and 64-bit keys, the merge
    over slices) on the edge cases and a blob, at slice plans for 132 SMs and
    for 1 (one slice), equal the plain version bit for bit."""
    dirs = _hull_directions(256)[:100]
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((5, h, w), bool)
    masks[1, h // 3, w // 2] = True
    masks[2] = True
    masks[3] = ((yy - (h - 1) / 2) / (h / 2)) ** 2 + ((xx - (w - 1) / 2) / (w / 2)) ** 2 <= 1.0
    rng = np.random.default_rng(h * w)
    for _ in range(3):
        cy, cx = rng.uniform(0.1, 0.9, 2) * (h, w)
        ry, rx = rng.uniform(0.05, 0.4, 2) * (h, w)
        masks[4] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    want, want_any = hull_support_plain(torch.from_numpy(masks), torch.from_numpy(dirs))
    for sms in (132, 1):
        got, got_any = _hull_support_as_the_frames_kernels_do(masks, dirs, sms)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got_any, want_any.numpy())


@pytest.mark.parametrize("n,h,w,d", [(1, 8192, 8192, 256), (1, 2049, 2049, 100), (1, 1, 40000, 256),
                                     (95, 300, 300, 256), (512, 257, 4000, 256), (3, 40000, 3, 7)])
def test_frame_plan_covers_every_chunk(n, h, w, d):
    """The selection's slices split the CHUNK-row chunks without an empty
    slice, and one mask alone is spread to one to four blocks an SM (132)."""
    chunks = -(-max(h, w) // CHUNK)
    slices, per = frame_plan(n, h, w, d, 132)
    assert per >= 1 and (slices - 1) * per < chunks <= slices * per and slices <= 65535
    blocks = n * -(-d // GROUP) * slices
    assert blocks >= min(132, n * -(-d // GROUP) * chunks)
    assert slices == 1 or blocks < 2 * (2 * 132 + n * -(-d // GROUP))


def test_hull_candidates_are_counted():
    """``hull_candidates.calls`` counts the plain front end: the CPU path
    calls it once a ``hull_support`` call (the card's path never)."""
    before = hull_candidates.calls
    hull_support(torch.zeros((2, 8, 8), dtype=torch.bool),
                 torch.from_numpy(_hull_directions(16)))
    assert hull_candidates.calls == before + 1


@pytest.mark.parametrize("gs,wg", [(32, 11), (64, 7)])
def test_window_crop_plain_takes_the_engines_starts(gs, wg):
    """K8: the starts as the engine hands them over, the two columns of one
    (N, 2) int64 tensor (strided views), some outside [0, gs - wg], against
    the Pallas kernel on the clipped int32 starts. A copy, so exact."""
    rng = np.random.default_rng(gs + wg)
    n, c = 6, 256
    grid = rng.normal(size=(n, gs, gs, c)).astype(np.float32)
    starts = rng.integers(-3, gs - wg + 4, size=(n, 2))
    starts[0], starts[1] = (-5, gs), (gs - wg, 0)
    st = torch.from_numpy(starts)
    assert st[:, 1].stride() == (2,)
    got = window_crop(torch.from_numpy(grid), st[:, 0], st[:, 1], wg)
    clipped = np.clip(starts, 0, gs - wg).astype(np.int32)
    want = j_window_crop(jnp.asarray(grid), jnp.asarray(clipped[:, 0]),
                         jnp.asarray(clipped[:, 1]), wg, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
