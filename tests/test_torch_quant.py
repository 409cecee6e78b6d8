"""The port's w8a8 (int8) path and the ViT-L/H routes against the JAX package,
on the CPU.

The same numpy weights and inputs go through ``yolo_sam_inference_tpu`` (its
Pallas kernels in interpret mode, as ``tests/test_quant.py`` runs them) and
through the port, whose kernel wrappers take their plain versions for CPU
tensors. fp32 throughout. The int8 kernels themselves are held against these
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from synth import make_cell_image
from yolo_sam_inference_tpu.models import sam as jsam_pkg
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.ops import fused_ln as jln
from yolo_sam_inference_tpu.ops import quant as jq
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.models.sam import (
    SamTPUConfig,
    init_sam_params,
    sam_tiny_test,
    sam_vit_h,
    sam_vit_l,
)
from yolo_sam_inference_tpu_torch.models.sam import model as tmodel
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
from yolo_sam_inference_tpu_torch.ops import quant as tq
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tail_case(seed, rows=64, c=128, hidden=512):
    """tests/test_quant.py's int8 tail case, quantised by the JAX package
    (weight spreads scaled with the fan-in, so wider cases keep its output
    size and its bounds)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, loc=0.0, std=1.0: rng.normal(loc, std, size=shape).astype(np.float32)
    x, a = f32(rows, c), f32(rows, c)
    scale, bias = f32(c, loc=1.0, std=0.1), f32(c, std=0.1)
    w1q, w1s = jq.quantize_weight(f32(c, hidden, std=0.06 * (128 / c) ** 0.5))
    b1 = f32(hidden, std=0.05)
    w2q, w2s = jq.quantize_weight(f32(hidden, c, std=0.06 * (512 / hidden) ** 0.5))
    b2 = f32(c, std=0.05)
    return x, a, scale, bias, w1q, w1s, b1, w2q, w2s, b2


def _assert_quant_parity(got, want):
    """tests/test_quant.py:197-208: a value on an int8 rounding boundary may
    resolve the other way after a 1-ulp difference upstream and move its row
    by one quantisation step; the unit of disagreement is a row. The bulk
    must match tightly; such rows are rare and step-bounded."""
    d = np.abs(got - want)
    bad_rows = d.reshape(-1, d.shape[-1]).max(axis=-1) > 2e-5
    assert bad_rows.mean() <= 0.06, bad_rows.mean()
    assert d.max() < 5e-3, d.max()


def _erf_kernel(y_ref, o_ref):
    o_ref[...] = jln._erf_as(y_ref[...], fast_recip=True)


def _tpu_erf_gelu(h):
    """The GELU of the TPU kernels: their rational erf (``_erf_as`` with its
    in-kernel reciprocal), evaluated as interpret mode evaluates it."""
    y = jnp.asarray(h.numpy() * np.float32(2 ** -0.5))
    e = pl.pallas_call(_erf_kernel, out_shape=jax.ShapeDtypeStruct(y.shape, y.dtype),
                       interpret=True)(y)
    return h * 0.5 * (1.0 + torch.from_numpy(np.array(e)))


# ------------------------------------------------------------------ quantisers


@pytest.mark.parametrize("shape,zero_col", [((256, 512), None), ((64, 48), 5), ((8, 4), "all")])
def test_quantize_weight_matches_jax_bitwise(shape, zero_col):
    rng = np.random.default_rng(shape[0])
    w = rng.normal(0, 0.05, size=shape).astype(np.float32)
    if zero_col == "all":
        w[:] = 0.0
    elif zero_col is not None:
        w[:, zero_col] = 0.0
    jwq, jws = jq.quantize_weight(w)
    for got_q, got_s in (tq.quantize_weight(w), tq.quantize_weight(torch.from_numpy(w))):
        np.testing.assert_array_equal(np.asarray(got_q), np.asarray(jwq))
        np.testing.assert_array_equal(np.asarray(got_s), np.asarray(jws))
        assert np.asarray(got_q).dtype == np.int8 and np.asarray(got_s).dtype == np.float32
    if zero_col is not None:
        assert (np.asarray(jws)[zero_col if zero_col != "all" else slice(None)] == 1.0).all()


def test_quantize_sam_encoder_params_matches_jax_bitwise():
    tree = init_sam_params(1, sam_tiny_test())
    got, want = tq.quantize_sam_encoder_params(tree), jq.quantize_sam_encoder_params(tree)
    for gl, wl, src in zip(got["vision"]["layers"], want["vision"]["layers"],
                           tree["vision"]["layers"]):
        for g, w in ((gl["attn"]["qkv"], wl["attn"]["qkv"]), (gl["mlp1"], wl["mlp1"]),
                     (gl["mlp2"], wl["mlp2"])):
            assert sorted(g) == sorted(w) == ["b", "wq", "wscale"]
            for key in ("wq", "wscale", "b"):
                assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]))
        assert "w" in gl["attn"]["proj"] and "w" in src["attn"]["qkv"]  # proj float, source intact
    assert got["decoder"] is tree["decoder"] and tq.quantize_sam_encoder_params({"x": 1}) == {"x": 1}


def test_int8_linear_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 4, 64)).astype(np.float32)
    wq, ws = jq.quantize_weight(rng.normal(size=(64, 48)).astype(np.float32))
    b = rng.normal(size=(48,)).astype(np.float32)
    got = tq.int8_linear(_t(x), _t(wq), _t(ws), _t(b)).numpy()
    want = np.asarray(jq.int8_linear(jnp.asarray(x), wq, ws, jnp.asarray(b)))
    # identical integers (exact accumulation on both sides); fp32 epilogue
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# --------------------------------------------------------- the w8a8 kernels


def test_fused_ln_matmul_int8_matches_jax():
    """K11c: the port's plain version against the interpret-mode TPU kernel."""
    x, _, scale, bias, wq, ws, b, _, _, _ = _tail_case(15, c=128, hidden=384)
    got = tln.fused_ln_matmul_int8(_t(x), _t(scale), _t(bias), _t(wq), _t(ws), _t(b)).numpy()
    want = np.asarray(jln.fused_ln_matmul_int8(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), wq, ws, jnp.asarray(b),
        interpret=True))
    _assert_quant_parity(got, want)


@pytest.mark.parametrize("with_attn", [True, False])
def test_fused_ln_mlp_int8_matches_jax(with_attn, monkeypatch):
    """K11a, with and without the attention residual. The TPU kernel's GELU
    uses a rational erf (|err| <= 3.4e-5) and requantises right after it,
    so against the port's exact erf most rows have a bucket moved by one
    step. With the TPU's erf put into the port's plain version the rest of
    the function (LN rounding, quantisers, chunks, epilogues) must agree to
    the row-flip bound; with the port's own erf, every difference is such a
    step: within 5e-3 and 0.5% of the MLP's contribution (its quantisation
    error against float is ~2%, tests/test_quant.py)."""
    x, a, *rest = _tail_case(11 if with_attn else 12)
    attn = a if with_attn else None
    want = np.asarray(jln.fused_ln_mlp_int8(
        jnp.asarray(x), None if attn is None else jnp.asarray(attn),
        *[jnp.asarray(v) for v in rest], interpret=True))
    args = (_t(x), None if attn is None else _t(attn), *[_t(v) for v in rest])
    got = tln.fused_ln_mlp_int8(*args).numpy()
    y = x if attn is None else x + attn
    assert np.abs(got - want).max() < 5e-3
    assert np.linalg.norm(got - want) / np.linalg.norm(want - y) < 5e-3
    monkeypatch.setattr(tln, "_gelu_f32", _tpu_erf_gelu)
    _assert_quant_parity(tln.fused_ln_mlp_int8(*args).numpy(), want)


@pytest.mark.parametrize("block_hidden", [128, 0])
def test_fused_ln_mlp_tiled_int8_matches_jax(block_hidden, monkeypatch):
    """K11b with nk > 1: 4 forced tiles of 128, and the tile rule's own
    choice at C = 512, hidden 8192 (nk = 2). Bounds as for K11a."""
    c, hidden = (128, 512) if block_hidden else (512, 8192)
    x, a, *rest = _tail_case(17, rows=32, c=c, hidden=hidden)
    nk = tln.int8_tail_chunks(32, c, hidden, tiled=True, block_hidden=block_hidden)
    assert nk == (4 if block_hidden else 2)
    want = np.asarray(jln.fused_ln_mlp_tiled_int8(
        jnp.asarray(x), jnp.asarray(a), *[jnp.asarray(v) for v in rest],
        block_rows=32, block_hidden=block_hidden, interpret=True))
    args = (_t(x), _t(a), *[_t(v) for v in rest])
    got = tln.fused_ln_mlp_tiled_int8(*args, block_rows=32, block_hidden=block_hidden).numpy()
    assert np.abs(got - want).max() < 5e-3
    assert np.linalg.norm(got - want) / np.linalg.norm(want - (x + a)) < 5e-3
    monkeypatch.setattr(tln, "_gelu_f32", _tpu_erf_gelu)
    _assert_quant_parity(tln.fused_ln_mlp_tiled_int8(*args, block_rows=32,
                                                     block_hidden=block_hidden).numpy(), want)


def _pallas_eqns(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            yield eqn
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                yield from _pallas_eqns(sub if hasattr(sub, "eqns") else sub.jaxpr)


def _jax_chunks(fn, m, c, hidden):
    """The chunk count a JAX int8 tail kernel uses at (m, c, hidden), read
    from its traced program (shapes only, nothing computed): K11b's hidden
    grid dimension, or half of K11a's int8 contractions."""
    s = lambda *shape, dt=jnp.float32: jax.ShapeDtypeStruct(shape, dt)
    args = (s(m, c, dt=jnp.bfloat16), s(m, c, dt=jnp.bfloat16), s(c), s(c),
            s(c, hidden, dt=jnp.int8), s(hidden), s(hidden), s(hidden, c, dt=jnp.int8), s(c), s(c))
    (eqn,) = _pallas_eqns(jax.make_jaxpr(lambda *a: fn(*a))(*args).jaxpr)
    if fn is jln.fused_ln_mlp_tiled_int8:
        return eqn.params["grid_mapping"].grid[1]
    return sum(e.primitive.name == "dot_general" for e in eqn.params["jaxpr"].eqns) // 2


@pytest.mark.parametrize("m,c,hidden", [
    (32768, 768, 3072), (32768, 1024, 4096), (32768, 1280, 5120),  # ViT-B/L/H, batch 32
    (1024, 1280, 5120), (32768, 2048, 8192), (512, 256, 1000),
])
def test_int8_tail_chunks_match_jax_rules(m, c, hidden):
    """The chunk count is part of the function: the port's rule against the
    JAX kernels' own, for both tails. At batch 32 the encoders' routes (K11a
    for ViT-B/L, K11b for ViT-H) all give 4; the tiled rule gives 2 at
    ViT-B/L widths and 16 at C = 2048, and K11a's gives 1 when 4 does not
    divide the hidden."""
    for fn, tiled in ((jln.fused_ln_mlp_int8, False), (jln.fused_ln_mlp_tiled_int8, True)):
        assert tln.int8_tail_chunks(m, c, hidden, tiled) == _jax_chunks(fn, m, c, hidden), fn
    route_tiled = c * hidden > tmodel.RESIDENT_MLP_INT8_MAX
    if (c, hidden) in ((768, 3072), (1024, 4096), (1280, 5120)):
        assert tln.int8_tail_chunks(m, c, hidden, route_tiled) == 4


# --------------------------------------------------- bridge, configs, routes


def test_from_jax_params_takes_a_quantized_tree():
    cfg = sam_tiny_test()
    tree = jq.quantize_sam_encoder_params(jsam_pkg.init_sam_params(2, cfg))
    _, sam = from_jax_params(None, tree, "cpu", torch.bfloat16, sam_config=cfg)
    layer, jl = sam.vision.layers[0], tree["vision"]["layers"][0]
    assert layer.int8 and layer.qkv.wq.dtype == layer.mlp2.wq.dtype == torch.int8
    assert layer.qkv.wscale.dtype == layer.mlp1.wscale.dtype == torch.float32
    np.testing.assert_array_equal(layer.mlp1.wq.numpy(), np.asarray(jl["mlp1"]["wq"]))
    np.testing.assert_array_equal(layer.mlp1.wscale.numpy(), np.asarray(jl["mlp1"]["wscale"]))
    assert layer.mlp1.b.dtype == layer.proj.w.dtype == sam.decoder.iou_token.dtype == torch.bfloat16
    floats = [n for n, p in sam.named_parameters() if p.is_floating_point()]
    assert all(sam.get_parameter(n).dtype == torch.bfloat16 for n in floats
               if not n.endswith(".wscale"))


def test_vit_configs_match_jax():
    for got, want in ((sam_vit_l(), jsam_pkg.sam_vit_l()), (sam_vit_h(512), jsam_pkg.sam_vit_h(512))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name in ("facebook/sam-vit-base", "facebook/sam-vit-large", "facebook/sam-vit-huge",
                 "vit-base", "vit-large", "vit-huge"):
        assert (dataclasses.asdict(tengine.SAM_CONFIGS[name]())
                == dataclasses.asdict(jengine.SAM_CONFIGS[name]()))
    with pytest.raises(ValueError, match="quant"):
        tengine.CellSegmentationPipeline(device="cpu", sam_config=sam_tiny_test(),
                                         options=tengine.PipelineOptions(quant="fp8"))


def _spy(monkeypatch, name, calls):
    fn = getattr(tmodel, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(tmodel, name, spy)


@pytest.mark.parametrize("quant", [False, True])
def test_wide_mlp_takes_the_tiled_routes(quant, monkeypatch):
    """C * hidden = 128 * 36864 is above both residency thresholds of the JAX
    encoder (2.4M bf16, 4.5M int8): float weights take K10 (the port's
    ``fused_ln_mlp``, K4's function), int8 weights K11c and K11b, and the
    outputs match the plain (oracle) path."""
    cfg = SamTPUConfig(image_size=32, patch_size=8, vision_hidden=128, vision_layers=1,
                       vision_heads=2, vision_mlp_dim=36864, window_size=4,
                       global_attn_indexes=(0,), output_channels=16)
    tree = init_sam_params(3, cfg)["vision"]
    if quant:
        tree = tq.quantize_sam_encoder_params({"vision": tree})["vision"]
    enc = tmodel.SamImageEncoder(tree, cfg)
    calls = []
    for name in ("fused_ln_mlp", "fused_ln_matmul", "fused_ln_matmul_int8",
                 "fused_ln_mlp_int8", "fused_ln_mlp_tiled_int8"):
        _spy(monkeypatch, name, calls)
    pix = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        got = enc(pix)
        assert calls == (["fused_ln_matmul_int8", "fused_ln_mlp_tiled_int8"] if quant
                         else ["fused_ln_matmul", "fused_ln_mlp"])
        torch.testing.assert_close(got, enc(pix, plain=True), rtol=0, atol=0)


# ------------------------------------------------------------------ the slice

OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=48, nms_candidates=64)


@pytest.fixture(scope="module")
def both_int8():
    rng = np.random.default_rng(0)
    frames = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    jp = jengine.CellSegmentationPipeline(
        sam_config=jsam_pkg.sam_tiny_test(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, quant="int8", **OPTS),
    )
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, quant="int8", **OPTS),
    )
    return frames, jp, tp, jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)


def test_slice_int8_matches_jax(both_int8):
    """The int8 pipelines of both packages, same seed and frames, fp32. The
    JAX CPU run takes the unfused int8 path (one activation scale per row of
    the hidden, exact-erf GELU); the port runs K11c and K11a (a scale per
    hidden chunk). So the bar is the JAX package's own int8 acceptance
    (tests/test_quant.py:99-140): embeddings within 5% relative RMS,
    detections equal, masks IoU >= 0.95 and deformability within 0.02 on
    the cells valid in both."""
    frames, jp, tp, jo, to = both_int8
    h, w = frames.shape[1:3]
    jst, tst = jp._stages(h, w), tp._stages(h, w)
    assert tst["sam"].vision.layers[0].int8
    with torch.inference_mode():
        emb = tst["embed"](torch.from_numpy(frames)).numpy()
    jemb = np.asarray(jst["embed"](jst["sam_params"], jnp.asarray(frames)))
    rel = np.linalg.norm(emb - jemb) / np.linalg.norm(jemb)
    assert rel < 0.05, rel
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    both = to["valid"] & jo["valid"]
    assert both.any()
    mt, mj = to["mask_crops"][both], jo["mask_crops"][both]
    iou = (mt & mj).sum(axis=(-2, -1)) / np.maximum((mt | mj).sum(axis=(-2, -1)), 1)
    assert (iou >= 0.95).all(), iou
    dt, dj = to["metrics"]["deformability"][both], jo["metrics"]["deformability"][both]
    assert np.max(np.abs(dt - dj)) < 0.02
