"""K12 and the encoder's flat route against the JAX package, on the CPU.

On the CPU ``flash_attention_relpos`` (q, k and v as views of a fused qkv,
the raw rel-pos tables) takes its plain version, held here against the JAX
package's Pallas kernel in interpret mode (as
``tests/test_flash_attention.py`` runs it) on score tables built as the JAX
encoder builds them, for the whole grid and for a row-aligned subset of the
queries from a row ``row0`` > 0 (a sequence-parallel rank's rows); its
attention given the tables (``flash_attention_relpos_plain``) is held
against the same kernel and the JAX naive oracle. The flat encoder route
(grids the window does not divide, and on the card the grids that are
multiples of 14 but not of 16) is held against JAX ``sam_image_encoder``, which on the CPU always takes its flat
route; and an off-grid pipeline against the JAX pipeline, in float and
with int8 weights (the flat route's qkv, mlp1 and mlp2 on ``int8_linear``,
as JAX's ``apply_linear``). Everything runs in fp32, where the TPU kernel's
bf16 casts of the logits are no-ops.
Random LayerNorm shifts and qkv biases keep the pad tokens' keys nonzero.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.models.sam import convert as jconvert
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.ops import flash_attention as jfa
from yolo_sam_inference_tpu.ops import quant as jq
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.models.sam import (
    SamImageEncoder,
    adapt_resolution,
    init_sam_params,
    sam_tiny_test,
    sam_vit_b,
)
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops import flash_attention as tfa
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(1)

# fp32 on both sides; only the summation order differs
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)
ENC_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _k12_case(seed, bh, s, hd):
    rng = np.random.default_rng(seed)
    n = s * s
    q, k, v = (rng.normal(size=(bh, n, hd)).astype(np.float32) for _ in range(3))
    rh, rw = ((0.5 * rng.normal(size=(bh, n, s))).astype(np.float32) for _ in range(2))
    return q, k, v, rh, rw


@pytest.mark.parametrize("s,hd,shard", [(8, 32, None), (8, 32, (1, 4)), (8, 64, (3, 4)),
                                        (8, 80, None), (14, 64, None), (14, 80, (1, 2))])
def test_relpos_plain_matches_jax_kernel(s, hd, shard):
    """K12's attention given its score tables: whole-grid q, or the rows of
    shard i of n (NQ = N / n); S = 14 has N = 196 keys, not a multiple of
    the card kernel's 64-key tiles."""
    q, k, v, rh, rw = _k12_case(s * hd, 3, s, hd)
    n = s * s
    nq = n if shard is None else n // shard[1]
    sl = slice(0, n) if shard is None else slice(shard[0] * nq, (shard[0] + 1) * nq)
    got = tfa.flash_attention_relpos_plain(_t(q[:, sl]), _t(k), _t(v), _t(rh[:, sl]),
                                           _t(rw[:, sl]), s)
    block_q = max(d for d in range(1, nq + 1) if nq % d == 0 and d <= 64)
    kern = jfa.flash_attention_relpos(
        jnp.asarray(q[:, sl]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(rh[:, sl]),
        jnp.asarray(rw[:, sl]), grid_s=s, block_q=block_q, block_k=n if s == 14 else 2 * s,
        interpret=True)
    full = jfa.reference_attention_relpos(*(jnp.asarray(a) for a in (q, k, v, rh, rw)), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **ATTN_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(full)[:, sl], **ATTN_TOL)


@pytest.mark.parametrize("row0,rows", [(0, 8), (2, 2), (6, 2)])
def test_relpos_score_tables_match_jax(row0, rows):
    """The tables of a rank's rows [row0, row0 + rows) of an 8 x 8 grid, as
    JAX ``parallel/sp.py:146-164`` builds them (``model.py:230-236`` for the
    whole grid)."""
    rng = np.random.default_rng(row0)
    s, b, heads, hd = 8, 2, 3, 16
    q = rng.normal(size=(b, heads, rows * s, hd)).astype(np.float32)
    rel_h, rel_w = (rng.normal(size=(2 * s - 1, hd)).astype(np.float32) for _ in range(2))
    rh, rw = tfa.relpos_score_tables(_t(q.reshape(b * heads, rows * s, hd)), _t(rel_h),
                                     _t(rel_w), s, row0=row0)
    rel_idx = (jnp.arange(rows) + row0)[:, None] - jnp.arange(s)[None, :] + s - 1
    rh_t = jnp.take(jnp.asarray(rel_h), rel_idx, axis=0)
    idx_w = np.arange(s)[:, None] - np.arange(s)[None, :] + s - 1
    rw_t = jnp.asarray(rel_w)[idx_w]
    qg = jnp.asarray(q).reshape(b, heads, rows, s, hd)
    want_h = jnp.einsum("bhqwc,qkc->bhqwk", qg, rh_t).reshape(b * heads, rows * s, s)
    want_w = jnp.einsum("bhqwc,wkc->bhqwk", qg, rw_t).reshape(b * heads, rows * s, s)
    np.testing.assert_allclose(rh.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rw.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-5)


def _jax_tables(q, rel_h, rel_w, s, row0):
    """rh, rw (B*heads, NQ, S) of q (B, heads, NQ, hd) from absolute row
    row0, as JAX ``models/sam/model.py:230-236`` (row0 0) and
    ``parallel/sp.py:146-164`` build them."""
    b, heads, nq, hd = q.shape
    rows = nq // s
    rel_idx = (jnp.arange(rows) + row0)[:, None] - jnp.arange(s)[None, :] + s - 1
    rh_t = jnp.take(jnp.asarray(rel_h), rel_idx, axis=0)
    idx_w = np.arange(s)[:, None] - np.arange(s)[None, :] + s - 1
    rw_t = jnp.asarray(rel_w)[idx_w]
    qg = jnp.asarray(q).reshape(b, heads, rows, s, hd)
    rh = jnp.einsum("bhqwc,qkc->bhqwk", qg, rh_t).reshape(b * heads, nq, s)
    rw = jnp.einsum("bhqwc,wkc->bhqwk", qg, rw_t).reshape(b * heads, nq, s)
    return rh, rw


def jax_relpos_attention(q, k, v, rel_h, rel_w, s, row0, heads):
    """JAX ``flash_attention_relpos`` (interpret mode) on (B, T, C) numpy q,
    k, v with the tables of :func:`_jax_tables` -> (B, NQ, C)."""
    b, nq, c = q.shape
    hd = c // heads
    n = s * s

    def hm(a):  # (B, T, C) -> (B, heads, T, hd)
        return np.ascontiguousarray(a.reshape(b, -1, heads, hd).transpose(0, 2, 1, 3))

    qh = hm(q)
    rh, rw = _jax_tables(qh, rel_h, rel_w, s, row0)
    block_q = max(d for d in range(1, nq + 1) if nq % d == 0 and d <= 64)
    out = jfa.flash_attention_relpos(
        jnp.asarray(qh.reshape(b * heads, nq, hd)), jnp.asarray(hm(k).reshape(b * heads, n, hd)),
        jnp.asarray(hm(v).reshape(b * heads, n, hd)), rh, rw, grid_s=s, block_q=block_q,
        block_k=n if s == 14 else 2 * s, interpret=True)
    return np.asarray(out).reshape(b, heads, nq, hd).transpose(0, 2, 1, 3).reshape(b, nq, c)


@pytest.mark.parametrize("s,hd,heads,rows,row0", [(8, 64, 2, 8, 0), (14, 64, 2, 14, 0),
                                                  (8, 80, 2, 2, 4), (14, 80, 1, 7, 7)])
def test_relpos_entry_matches_jax_kernel(s, hd, heads, rows, row0):
    """The strided entry (q, k, v as views of one fused qkv; raw rel-pos
    tables): a whole grid, S = 14 (196 keys), and a rank's rows from row0 >
    0, at hd 64 and 80."""
    rng = np.random.default_rng(100 * s + hd + row0)
    b, c = 2, heads * hd
    qkv = rng.normal(size=(b, s * s, 3 * c)).astype(np.float32)
    rel_h, rel_w = (0.5 * rng.normal(size=(2 * s - 1, hd)).astype(np.float32) for _ in range(2))
    q = qkv[:, row0 * s:(row0 + rows) * s, :c]
    t = _t(qkv)
    got = tfa.flash_attention_relpos(t[:, row0 * s:(row0 + rows) * s, :c], t[..., c:2 * c],
                                     t[..., 2 * c:], _t(rel_h), _t(rel_w), s, row0=row0)
    want = jax_relpos_attention(q, qkv[..., c:2 * c], qkv[..., 2 * c:], rel_h, rel_w, s, row0,
                                heads)
    assert got.shape == (b, rows * s, c)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_relpos_wrappers_refuse_bad_shapes():
    rng = np.random.default_rng(0)
    q, k, v = (_t(rng.normal(size=(1, 64, 32))) for _ in range(3))
    rel = _t(rng.normal(size=(15, 16)))
    with pytest.raises(ValueError, match="grid"):
        tfa.flash_attention_relpos(q, k, v, rel, rel, 7)
    with pytest.raises(ValueError, match="rel-pos tables"):
        tfa.flash_attention_relpos(q, k, v, rel[:13], rel[:13], 8)
    with pytest.raises(ValueError, match="from row 1"):
        tfa.flash_attention_relpos(q, k, v, rel, rel, 8, row0=1)
    with pytest.raises(ValueError, match="whole"):
        tfa.relpos_score_tables(q[:, :12], _t(np.zeros((15, 16))), _t(np.zeros((15, 16))), 8)


def _randomise(tree, seed):
    """Random pos embed, rel-pos tables, LN affines and qkv biases (zeros
    hide the pad tokens' keys and the rel-pos offsets)."""
    rng = np.random.default_rng(seed)
    v = tree["vision"]

    def rnd(a, scale):
        return (scale * rng.normal(size=np.shape(a))).astype(np.float32)

    v["pos_embed"] = rnd(v["pos_embed"], 0.1)
    for lp in v["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = rnd(lp["attn"][key], 0.3)
        lp["attn"]["qkv"]["b"] = rnd(lp["attn"]["qkv"]["b"], 0.5)
        lp["attn"]["proj"]["b"] = rnd(lp["attn"]["proj"]["b"], 0.1)
        for name in ("ln1", "ln2"):
            lp[name]["scale"] = 1.0 + rnd(lp[name]["scale"], 0.1)
            lp[name]["bias"] = rnd(lp[name]["bias"], 0.3)
    return tree


def _encoders(tree, cfg, pix):
    got = SamImageEncoder(tree["vision"], cfg)(_t(pix)).detach().numpy()
    return got, np.asarray(jsam.sam_image_encoder(tree, jnp.asarray(pix), cfg))


@pytest.mark.parametrize("image_size,window", [(80, 4), (72, 2)])
def test_flat_encoder_matches_jax_padded(image_size, window):
    """Grids 10 and 9 with windows 4 and 2: partitions zero-padded to 12 and
    10; the pad tokens' keys (qkv bias) are attended to, unmasked."""
    cfg = dataclasses.replace(sam_tiny_test(), image_size=image_size, window_size=window)
    tree = _randomise(init_sam_params(1, cfg), 2)
    enc = SamImageEncoder(tree["vision"], cfg)
    assert not enc.grid_route()
    pix = np.random.default_rng(3).normal(size=(2, image_size, image_size, 3)).astype(np.float32)
    got, want = _encoders(tree, cfg, pix)
    np.testing.assert_allclose(got, want, **ENC_TOL)


def test_flat_encoder_matches_jax_at_vit_b_640():
    """ViT-B widths (C 768, 12 heads, MLP 3072) at the 640 canvas (grid 40,
    window 14 padded to 42), cut to 2 layers: one windowed, one global;
    weights adapted from the 1024 tree by each package's adapt_resolution."""
    base = dataclasses.replace(sam_vit_b(), vision_layers=2, global_attn_indexes=(1,))
    cfg = dataclasses.replace(base, image_size=640, window_size=14)
    tree = init_sam_params(4, base)
    tree = {"vision": tree["vision"]}
    adapted = adapt_resolution(tree, cfg)
    jadapted = jconvert.adapt_resolution(tree, cfg)
    np.testing.assert_array_equal(adapted["vision"]["pos_embed"], jadapted["vision"]["pos_embed"])
    tree = _randomise(adapted, 5)
    pix = np.random.default_rng(6).normal(size=(1, 640, 640, 3)).astype(np.float32)
    got, want = _encoders(tree, cfg, pix)
    assert got.shape == (1, 40, 40, 256)
    np.testing.assert_allclose(got, want, **ENC_TOL)


@pytest.mark.parametrize("image_size", [224, 448])
def test_grids_of_14_take_the_flat_route_on_the_card(image_size):
    """Grids 14 and 28 at window 14 (the 224 and 448 canvases; 896 is grid
    56): the window attention kernel takes no window of 14, so the encoder
    takes the flat route, without padding, on every device. It equals JAX
    (whose CPU run takes its flat route, unpadded; its grid route computes
    the same function)."""
    cfg = dataclasses.replace(sam_tiny_test(), image_size=image_size, patch_size=16,
                              window_size=14)
    tree = _randomise(init_sam_params(7, cfg), 8)
    enc = SamImageEncoder(tree["vision"], cfg)
    assert not enc.grid_route()
    assert SamImageEncoder(tree["vision"], dataclasses.replace(cfg, window_size=7)).grid_route()
    pix = np.random.default_rng(9).normal(size=(1, image_size, image_size, 3)).astype(np.float32)
    got, want = _encoders(tree, cfg, pix)
    np.testing.assert_allclose(got, want, **ENC_TOL)


def test_flat_route_counts_its_layer_norms(monkeypatch):
    """Per layer: LN1 plain at layer 0, else the residual form (K11d), and
    LN2 residual: 2 layers -> 1 plain + 3 residual calls, then the neck's 2
    plain ones."""
    from yolo_sam_inference_tpu_torch.models.sam import model as tmodel

    calls = []
    real = tmodel.layer_norm

    def spy(x, scale, bias, eps=1e-6, residual=None):
        calls.append(residual is not None)
        return real(x, scale, bias, eps, residual=residual)

    monkeypatch.setattr(tmodel, "layer_norm", spy)
    cfg = dataclasses.replace(sam_tiny_test(), image_size=72)  # grid 9, window 2
    enc = SamImageEncoder(init_sam_params(0, cfg)["vision"], cfg)
    enc(torch.zeros(1, 72, 72, 3))
    assert calls == [False, True, True, True, False, False]


def _vit_b_640_tree():
    base = dataclasses.replace(sam_vit_b(), vision_layers=2, global_attn_indexes=(1,))
    cfg = dataclasses.replace(base, image_size=640, window_size=14)
    tree = _randomise(adapt_resolution({"vision": init_sam_params(4, base)["vision"]}, cfg), 5)
    return cfg, tree, np.random.default_rng(6).normal(size=(1, 640, 640, 3)).astype(np.float32)


def test_int8_flat_encoder_matches_jax_tiny():
    """int8 weights on the flat route (grid 9, windows of 2 padded to 10):
    qkv, mlp1 (+ GELU) and mlp2 through ``int8_linear``, the projection
    float, against JAX ``sam_image_encoder`` on the same quantised tree (its
    ``apply_linear``: per-row int8, exact integer products). fp32 both
    sides, no value lands on an int8 rounding boundary here: ENC_TOL."""
    cfg = dataclasses.replace(sam_tiny_test(), image_size=72)
    tree = jq.quantize_sam_encoder_params(_randomise(init_sam_params(1, cfg), 2))
    enc = SamImageEncoder(tree["vision"], cfg)
    assert not enc.grid_route() and enc.layers[0].int8
    pix = np.random.default_rng(3).normal(size=(2, 72, 72, 3)).astype(np.float32)
    got, want = _encoders(tree, cfg, pix)
    np.testing.assert_allclose(got, want, **ENC_TOL)


def test_int8_flat_encoder_matches_jax_at_vit_b_640():
    """The int8 flat route at ViT-B widths, the 640 canvas, 2 layers. Here
    many activations sit near an int8 rounding boundary: a 1e-6 relative
    change of the pixels alone moves the port's own int8 embedding by 0.7%
    RMS (the float one by 1.5e-6), and fp32 summation orders differ between
    the packages by more. So the bar is 2% relative RMS against JAX's int8
    encoder, and closer to it than to the float encoder (int8 against float
    is ~2%)."""
    cfg, tree, pix = _vit_b_640_tree()
    q = jq.quantize_sam_encoder_params(tree)
    got, want = _encoders(q, cfg, pix)
    with torch.no_grad():
        flt = SamImageEncoder(tree["vision"], cfg)(_t(pix)).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 0.02 and rel < np.linalg.norm(got - flt) / np.linalg.norm(flt), rel


OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64,
            sam_encoder_size=72)  # grid 9 at the tiny config's window 2: the flat route


@pytest.fixture(scope="module")
def offgrid_both():
    rng = np.random.default_rng(11)
    frames = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    jp = jengine.CellSegmentationPipeline(
        sam_config=sam_tiny_test(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS),
    )
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS),
    )
    return frames, jp, tp, jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)


@pytest.fixture(scope="module")
def offgrid_int8_both():
    rng = np.random.default_rng(12)
    frames = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    jp = jengine.CellSegmentationPipeline(
        sam_config=sam_tiny_test(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, quant="int8", **OPTS),
    )
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, quant="int8", **OPTS),
    )
    return frames, jp, tp, jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)


def test_offgrid_int8_pipeline_matches_jax(offgrid_int8_both):
    """``quant="int8"`` with ``sam_encoder_size`` 72 (the flat route): the
    port's int8 pipeline against the JAX one, same seed and frames, fp32;
    the bounds of the float off-grid pipeline."""
    frames, jp, tp, jo, to = offgrid_int8_both
    h, w = frames.shape[1:3]
    jst, tst = jp._stages(h, w), tp._stages(h, w)
    assert tst["sam"].vision.layers[0].int8 and not tst["sam"].vision.grid_route()
    with torch.inference_mode():
        emb = tst["embed"](torch.from_numpy(frames)).numpy()
    jemb = np.asarray(jst["embed"](jst["sam_params"], jnp.asarray(frames)))
    np.testing.assert_allclose(emb, jemb, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    assert (to["mask_crops"] == jo["mask_crops"]).mean() >= 0.995


def test_offgrid_pipeline_matches_jax(offgrid_both):
    """Same seed, frames and options (sam_encoder_size 72: grid 9, windows of
    2 padded to 10): embeddings within 1e-4, detections equal, masks agree
    on >= 99.5% of pixels (an embedding difference of 1e-5 can flip a logit
    that sits at 0)."""
    frames, jp, tp, jo, to = offgrid_both
    h, w = frames.shape[1:3]
    jst, tst = jp._stages(h, w), tp._stages(h, w)
    assert tst["scfg"].grid_size == 9 and not tst["sam"].vision.grid_route()
    with torch.inference_mode():
        emb = tst["embed"](torch.from_numpy(frames)).numpy()
    jemb = np.asarray(jst["embed"](jst["sam_params"], jnp.asarray(frames)))
    np.testing.assert_allclose(emb, jemb, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    assert (to["mask_crops"] == jo["mask_crops"]).mean() >= 0.995
