"""The port's decoder, window-crop and hull kernels (K6-K9) against the JAX
package, on the CPU.

On the CPU the wrappers of ``yolo_sam_inference_tpu_torch`` take their plain
PyTorch versions; these tests hold them against the JAX package's Pallas
kernels in interpret mode (as ``tests/test_decoder_fused.py`` runs them), in
fp32, on the same numpy inputs. The CUDA kernels are compared with the plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_sam_inference_tpu.models.sam import init_sam_params, sam_tiny_test
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.ops.decoder_fused import i2t_keys_update as j_i2t
from yolo_sam_inference_tpu.ops.decoder_fused import t2i_shared_attend as j_t2i
from yolo_sam_inference_tpu.ops.hull_support import support_vertices_tpu
from yolo_sam_inference_tpu.ops.window_crop import window_crop as j_window_crop
from yolo_sam_inference_tpu_torch.models.sam import SamModel
from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
from yolo_sam_inference_tpu_torch.ops.hull_support import support_points
from yolo_sam_inference_tpu_torch.ops.metrics import _hull_directions
from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop

torch.set_num_threads(1)

HEADS, HD, TQ, T, C = 2, 8, 3, 16, 32
DH = HEADS * HD


def _f(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _weights(rng):
    return {"wq": _f(rng, C, DH, scale=0.3), "bq": _f(rng, DH, scale=0.1),
            "wout": _f(rng, DH, C, scale=0.3), "bout": _f(rng, C, scale=0.1),
            "lns": 1.0 + _f(rng, C, scale=0.1), "lnb": _f(rng, C, scale=0.1),
            "wk": _f(rng, C, DH, scale=0.3), "bk": _f(rng, DH, scale=0.1),
            "wv": _f(rng, C, DH, scale=0.3), "bv": _f(rng, DH, scale=0.1)}


@pytest.mark.parametrize("k_share", [1, 3])
def test_i2t_keys_update_matches_jax_kernel(k_share):
    """K7: i2t + residual + LN4 and the next stage's t2i, against the Pallas
    kernel with its fused t2i (interpret mode)."""
    rng = np.random.default_rng(20 + k_share)
    nsrc = 2
    n = nsrc * k_share
    w = _weights(rng)
    keys_src, pe = _f(rng, nsrc, T, C), _f(rng, 1, T, C)
    kq, vq = _f(rng, n, TQ, DH, scale=0.5), _f(rng, n, TQ, DH, scale=0.5)
    qp2 = _f(rng, n, TQ + 1, DH, scale=0.3)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    got_keys, got_attn = dec.i2t_keys_update(
        torch.from_numpy(keys_src), torch.from_numpy(pe), torch.from_numpy(kq),
        torch.from_numpy(vq), t["wq"], t["bq"], t["wout"], t["bout"], t["lns"], t["lnb"],
        heads=HEADS, k_share=k_share, eps=1e-6,
        t2i={"qp": torch.from_numpy(qp2), "wk": t["wk"], "bk": t["bk"], "wv": t["wv"],
             "bv": t["bv"]},
    )
    j = {k: jnp.asarray(v) for k, v in w.items()}
    want_keys, want_attn = j_i2t(
        jnp.asarray(keys_src), jnp.asarray(pe), jnp.asarray(kq), jnp.asarray(vq), j["wq"],
        j["bq"], j["wout"], j["bout"], j["lns"], j["lnb"], heads=HEADS, k_share=k_share,
        eps=1e-6, interpret=True,
        t2i={"qp": jnp.asarray(qp2), "wk": j["wk"], "bk": j["bk"], "wv": j["wv"], "bv": j["bv"]},
    )
    # fp32 both sides; the TPU kernel sums head groups and softmax
    # denominators through small matmuls, so the summation order differs
    np.testing.assert_allclose(got_keys.numpy(), np.asarray(want_keys), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("t,k_share", [(196, 1), (196, 16), (784, 1), (784, 16)])
def test_t2i_shared_attend_matches_jax_kernel(t, k_share):
    """K6: per-image k/v projections shared by k_share prompts, over the
    token counts of the 224 and 448 canvases (grids of 14 and 28)."""
    rng = np.random.default_rng(30 + t + k_share)
    b = 2
    w = _weights(rng)
    keys, pe = _f(rng, b, t, C), _f(rng, 1, t, C)
    qp = _f(rng, b * k_share, TQ, DH, scale=0.3)
    got = dec.t2i_shared_attend(torch.from_numpy(keys), torch.from_numpy(pe),
                                torch.from_numpy(qp), *(torch.from_numpy(w[k]) for k in
                                                        ("wk", "bk", "wv", "bv")),
                                HEADS, k_share)
    want = j_t2i(jnp.asarray(keys), jnp.asarray(pe), jnp.asarray(qp),
                 *(jnp.asarray(w[k]) for k in ("wk", "bk", "wv", "bv")), heads=HEADS,
                 k_share=k_share, interpret=True)
    # fp32; the TPU kernel computes all heads' logits in one block-diagonal dot
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _t2i_attend_as_the_kernel_tiles_it(qp, kp, vp, k_share, keys=64):
    """``t2i_attend_kernel``'s arithmetic in fp32 on the CPU: per image and
    head, all k_share * tq query rows against 64-key tiles (the last one
    short: its missing keys score -inf), an online softmax with running max
    and sum, e rounded to bf16 before P.V, the output divided by the fp32 sum
    at the end, in bf16."""
    n, tq, dh = qp.shape
    nsrc, t, _ = kp.shape
    q = qp.float().reshape(nsrc, k_share * tq, 8, 16).transpose(1, 2)  # (img, head, rows, 16)
    k = kp.float().reshape(nsrc, t, 8, 16).transpose(1, 2)
    v = vp.float().reshape(nsrc, t, 8, 16).transpose(1, 2)
    mx = torch.full(q.shape[:3], float("-inf"))
    sm = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for k0 in range(0, t, keys):
        s = torch.full((*q.shape[:3], keys), float("-inf"))
        s[..., :min(keys, t - k0)] = q @ k[:, :, k0:k0 + keys].transpose(-1, -2)
        new = torch.maximum(mx, s.amax(-1))
        corr = torch.exp(mx - new)
        e = torch.exp(s - new[..., None])
        sm = sm * corr + e.sum(-1)
        vt = torch.zeros((*v.shape[:2], keys, 16))
        vt[:, :, :min(keys, t - k0)] = v[:, :, k0:k0 + keys]
        o = o * corr[..., None] + e.to(torch.bfloat16).float() @ vt
        mx = new
    out = (o / sm[..., None]).transpose(1, 2).reshape(n, tq, dh)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("t,k_share", [(196, 16), (784, 1), (1024, 16)])
def test_kernel_tiling_of_t2i_attend_stays_within_its_gate(t, k_share):
    """The online softmax over 64-key tiles, with e rounded to bf16 before
    P.V (the kernel's order), against JAX's t2i attention, which rounds the
    normalised p instead (decoder_fused.py:223), run in interpret mode on the
    same bf16 inputs: within the 2% of range the card's check allows. T 196
    and 784 end on a short tile."""
    rng = np.random.default_rng(t + k_share)
    b, tq = 2, 7
    keys, pe = _f(rng, b, t, 256), _f(rng, 1, t, 256)
    wk, wv = _f(rng, 256, 128, scale=256 ** -0.5), _f(rng, 256, 128, scale=256 ** -0.5)
    bk, bv = _f(rng, 128, scale=0.1), _f(rng, 128, scale=0.1)
    qp = _f(rng, b * k_share, tq, 128, scale=0.5)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    kp, vp = dec.kv_project_plain(bf(keys), bf(pe), *map(torch.from_numpy, (wk, bk, wv, bv)))
    got = _t2i_attend_as_the_kernel_tiles_it(bf(qp), kp, vp, k_share)
    # JAX's kernel on the same bf16 k/v: its keys hold [vp | kp], and its
    # projections select them exactly (0/1 weights, zero biases and pe)
    stacked = jnp.asarray(torch.cat([vp, kp], -1).float().numpy(), jnp.bfloat16)
    sel = np.zeros((2, 256, 128), np.float32)
    sel[0, 128 + np.arange(128), np.arange(128)] = 1.0  # wk: the kp half
    sel[1, np.arange(128), np.arange(128)] = 1.0  # wv: the vp half
    zero = jnp.zeros(128, jnp.float32)
    want_k = j_t2i(stacked, jnp.zeros((1, t, 256), jnp.bfloat16),
                   jnp.asarray(bf(qp).float().numpy(), jnp.bfloat16),
                   jnp.asarray(sel[0], jnp.bfloat16), zero, jnp.asarray(sel[1], jnp.bfloat16),
                   zero, heads=8, k_share=k_share, interpret=True)
    want = np.asarray(want_k.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_decoder_matches_jax_fused_branch(monkeypatch):
    """The port's decoder (K6 + K7 order) against the JAX decoder's fused
    branch, its Pallas kernels in interpret mode."""
    cfg = sam_tiny_test()
    tree = init_sam_params(5, cfg)
    rng = np.random.default_rng(9)
    b, k, gs = 2, 3, cfg.grid_size
    emb = _f(rng, b, gs, gs, cfg.prompt_hidden)
    sparse = _f(rng, b, k, 2, cfg.prompt_hidden, scale=0.3)
    with torch.no_grad():
        iou, hyper, keys = SamModel(tree, cfg).mask_decoder_tokens(torch.from_numpy(emb),
                                                                    torch.from_numpy(sparse))
    monkeypatch.setattr(jsam, "_fused_i2t_enabled", lambda c: True)
    jiou, jhyper, jkeys = jsam.sam_mask_decoder_tokens(tree, jnp.asarray(emb),
                                                       jnp.asarray(sparse), cfg)
    # fp32, two decoder layers; the same bound the JAX package holds its
    # fused branch to against its plain one
    for got, want in ((iou, jiou), (hyper, jhyper), (keys, jkeys)):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_window_crop_matches_jax_kernel():
    """K8: a copy, so exact."""
    rng = np.random.default_rng(11)
    n, gs, c, wg = 6, 16, 128, 5
    grid = _f(rng, n, gs, gs, c)
    r0 = rng.integers(0, gs - wg + 1, n).astype(np.int32)
    c0 = rng.integers(0, gs - wg + 1, n).astype(np.int32)
    got = window_crop(torch.from_numpy(grid), torch.from_numpy(r0), torch.from_numpy(c0), wg)
    want = j_window_crop(jnp.asarray(grid), jnp.asarray(r0), jnp.asarray(c0), wg, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_support_points_match_jax_kernel():
    """K9: the support point per direction, with the lexicographic (r, c)
    tie-break. Candidates are real-valued (no near-ties that rounding could
    decide), with duplicates and, along direction 0 = (1, 0), exact score ties
    that the column must break."""
    rng = np.random.default_rng(12)
    n, p = 5, 64
    pts = _f(rng, n, p, 2, scale=20.0)
    pts[:, 10] = pts[:, 3]  # duplicated candidates
    top = pts[:, :, 0].max(axis=1)
    pts[:, 0, 0] = pts[:, 1, 0] = top + 1.0  # two candidates share the largest r
    dirs = _hull_directions(64)
    got = support_points(torch.from_numpy(pts), torch.from_numpy(dirs)).numpy()
    want = np.asarray(support_vertices_tpu(jnp.asarray(pts.transpose(0, 2, 1)),
                                           jnp.asarray(dirs), interpret=True)).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0, 1] == np.maximum(pts[:, 0, 1], pts[:, 1, 1])).all()  # the tie-break


@pytest.mark.parametrize("i2t", [True, False])
def test_slab_schedule_covers_each_weight_once(i2t):
    """keys_stream_kernel's weight ring: each slab is a 16 KB run of whole
    rows of one (in, out) weight, and the slabs of each weight, in the order
    the kernel takes them, tile its rows once: wq before wout before wk / wv
    (the q product, the output projection, then the k/v products)."""
    shapes = {"wq": (256, 128), "wout": (128, 256), "wk": (256, 128), "wv": (256, 128)}
    sched = dec.slab_schedule(i2t)
    assert len(sched) == (16 if i2t else 8)
    seen = {}
    for name, row0, rows in sched:
        assert rows * shapes[name][1] * 2 == dec.SLAB_BYTES
        seen.setdefault(name, []).append((row0, rows))
    assert list(seen) == (["wq", "wout", "wk", "wv"] if i2t else ["wk", "wv"])
    for name, runs in seen.items():
        covered = [r for row0, rows in runs for r in range(row0, row0 + rows)]
        assert covered == list(range(shapes[name][0])), name
    # the weights reach the kernel in their own layout: no packed copy
    w = torch.randn(256, 128).to(torch.bfloat16)
    assert dec._weight(w, (256, 128), w.device) is w


@pytest.mark.parametrize("t", [256, 196, 784])
def test_t2i_combine_joins_tile_partials(t):
    """The partials keys_stream_kernel stores per 128-token tile (o, max, sum
    for each head and next query), joined by t2i_combine, give the attention
    over the whole stream; at T = 196 and 784 (grids 14 and 28) the last
    tile is short. Slots of absent queries are never read."""
    rng = np.random.default_rng(13)
    n, tq2, heads, hd = 3, 7, 8, 16
    qn = torch.from_numpy(_f(rng, n, tq2, heads * hd, scale=0.5))
    kp, vp = (torch.from_numpy(_f(rng, n, t, heads * hd)) for _ in range(2))
    part = dec.t2i_tile_partials_plain(qn, kp, vp)
    tiles = -(-t // dec.KERNEL_ROWS)
    assert tuple(part.shape) == (n, tiles, heads * 8 * (hd + 2))
    part.view(n, tiles, heads, 8, hd + 2)[:, :, :, tq2:] = float("nan")
    got = dec.t2i_combine(part, tq2)
    want = dec.t2i_attend_plain(qn, kp, vp, heads)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, tq2, heads * hd)
    # fp32 on both sides, one bf16 rounding of the output
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("gs", [14, 28])
def test_tile_partials_match_jax_i2t_at_short_tiles(gs):
    """K7 as the card computes it at SAM's decoder widths (C 256, dh 128, 8
    heads) on grids of 14 and 28 (T = 196, 784: the last 128-token tile is
    short): the plain keys pass, its k/v projections, the per-tile partials
    and t2i_combine_plain against JAX i2t_keys_update (interpret mode)."""
    rng = np.random.default_rng(gs)
    n, t, c, dh, tq = 2, gs * gs, 256, 128, 7
    w = {"wq": _f(rng, c, dh, scale=c ** -0.5), "bq": _f(rng, dh, scale=0.1),
         "wout": _f(rng, dh, c, scale=dh ** -0.5), "bout": _f(rng, c, scale=0.1),
         "lns": 1.0 + _f(rng, c, scale=0.1), "lnb": _f(rng, c, scale=0.1),
         "wk": _f(rng, c, dh, scale=c ** -0.5), "bk": _f(rng, dh, scale=0.1),
         "wv": _f(rng, c, dh, scale=c ** -0.5), "bv": _f(rng, dh, scale=0.1)}
    keys_src, pe = _f(rng, n, t, c), _f(rng, 1, t, c)
    kq, vq = _f(rng, n, tq, dh, scale=0.5), _f(rng, n, tq, dh, scale=0.5)
    qn = _f(rng, n, tq, dh, scale=0.25)
    tt = {k: torch.from_numpy(v) for k, v in w.items()}
    keys, _ = dec.i2t_keys_update_plain(
        torch.from_numpy(keys_src), torch.from_numpy(pe), torch.from_numpy(kq),
        torch.from_numpy(vq), tt["wq"], tt["bq"], tt["wout"], tt["bout"], tt["lns"], tt["lnb"],
        heads=8, t2i={"qp": torch.from_numpy(qn), "wk": tt["wk"], "bk": tt["bk"],
                      "wv": tt["wv"], "bv": tt["bv"]})
    kp, vp = dec.kv_project_plain(keys, torch.from_numpy(pe), tt["wk"], tt["bk"], tt["wv"],
                                  tt["bv"])
    part = dec.t2i_tile_partials_plain(torch.from_numpy(qn), kp, vp)
    assert part.shape[1] == -(-t // dec.KERNEL_ROWS) and t % dec.KERNEL_ROWS
    got = dec.t2i_combine_plain(part, tq)
    j = {k: jnp.asarray(v) for k, v in w.items()}
    want_keys, want_attn = j_i2t(
        jnp.asarray(keys_src), jnp.asarray(pe), jnp.asarray(kq), jnp.asarray(vq), j["wq"],
        j["bq"], j["wout"], j["bout"], j["lns"], j["lnb"], heads=8, eps=1e-6, interpret=True,
        t2i={"qp": jnp.asarray(qn), "wk": j["wk"], "bk": j["bk"], "wv": j["wv"], "bv": j["bv"]})
    # fp32 both sides (summation orders differ); the combine rounds to bf16 once
    np.testing.assert_allclose(keys.numpy(), np.asarray(want_keys), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want_attn), rtol=1e-2, atol=1e-2)


def test_keys_stream_launch_refuses_cpu_tensors():
    """keys_stream is the kernel launch itself; the CPU path goes through the
    dispatching functions, which take the plain versions."""
    x = torch.zeros(1, 64, 256)
    w, b = torch.zeros(256, 128), torch.zeros(128)
    with pytest.raises(ValueError, match="CUDA kernel"):
        dec.keys_stream(x, x[0], w, b, w, b)
    kp, vp = dec.kv_project(x, x[0], w, b, w, b, 8)
    assert tuple(kp.shape) == tuple(vp.shape) == (1, 64, 128)
