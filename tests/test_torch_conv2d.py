"""The port's dense conv (K17, ``ops/conv2d_fused.py``) and the
``conv2d_fused`` route against the JAX package, on the CPU.

The JAX side reaches its Pallas kernel as ``tests/test_conv2d_fused.py``
does: ``conv2d_act(..., interpret=True)``, or the model code with the gate
``conv2d_fused_enabled`` forced on (the stems, at Ci = 3, and widths below
16 still go to XLA there: ``conv2d_supported``). All fp32, inputs from
numpy seeds. The CUDA kernel is held against ``conv2d_act_plain`` on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synth import make_cell_image
from test_conv2d_fused import CASES
from test_torch_pipeline import OPTS
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.models.sam import tinyvit as jtv
from yolo_sam_inference_tpu.models.yolo import YoloConfig as JaxYoloConfig
from yolo_sam_inference_tpu.models.yolo import model as jyolo
from yolo_sam_inference_tpu.ops import conv2d_fused as jconv
from yolo_sam_inference_tpu.pipeline import engine as jengine
from yolo_sam_inference_tpu_torch.models.sam import (
    SamModel,
    TinyViT,
    TinyViTConfig,
    init_tinyvit_params,
    sam_tiny_test,
)
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig, YoloV8, init_yolo_params
from yolo_sam_inference_tpu_torch.models.yolo import model as tyolo
from yolo_sam_inference_tpu_torch.ops.conv2d_fused import (
    conv2d_act,
    conv2d_act_plain,
    conv_weight_matrix,
)
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.weights import from_jax_params

from test_torch_models import _tiny_sam_tree
from test_torch_tinyvit import _rand_tinyvit_tree

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture
def forced(monkeypatch):
    """The JAX gate forced on: its model code calls its ``conv2d_act`` (the
    Pallas kernel in interpret mode off the TPU) wherever the TPU kernel
    takes the geometry."""
    monkeypatch.setattr(jconv, "conv2d_fused_enabled", lambda k=1: True)


def _jax_ref(x, w, b, k, stride, act):
    """``lax.conv_general_dilated`` with K17's padding geometry, fp32."""
    pad = {3: ((1, 1), (1, 1)), 2: ((1, 0), (1, 0)), 1: ((0, 0), (0, 0))}[k]
    y = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), pad,
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    if act == "silu":
        y = jax.nn.silu(y)
    elif act == "gelu":
        y = jax.nn.gelu(y, approximate=False)
    return np.asarray(y)


@pytest.mark.parametrize("case", CASES,
                         ids=[f"k{k}s{s}ci{ci}{a}" for (_, _, _, ci, _, k, s, a) in CASES])
def test_conv2d_act_plain_matches_jax_kernel(case):
    """The JAX parity cases (one per geometry class) against the Pallas
    kernel in interpret mode; GELU within its rational erf's bound."""
    b, h, w_, ci, co, k, s, act = case
    rng = np.random.default_rng(hash(case) & 0xFFFF)
    x = rng.normal(size=(b, h, w_, ci)).astype(np.float32)
    w = (rng.normal(size=(k, k, ci, co)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    want = np.asarray(jconv.conv2d_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), k=k,
                                       stride=s, act=act, interpret=True))
    got = conv2d_act_plain(_t(x), _t(w), _t(bias), k, s, act)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(conv2d_act(_t(x), _t(w), _t(bias), k, s, act).numpy(),
                                  got.numpy())


def test_conv2d_act_plain_bf16_matches_jax_kernel():
    """bf16 in and out, as ``tests/test_conv2d_fused.py`` holds the TPU kernel."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 64, 32)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(32,)).astype(np.float32)
    want = jconv.conv2d_act(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                            jnp.asarray(bias), k=3, stride=2, act="silu", interpret=True)
    got = conv2d_act_plain(_t(x).bfloat16(), _t(w).bfloat16(), _t(bias), 3, 2, "silu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.1,
                               rtol=0.05)


@pytest.mark.parametrize("b,h,w_,ci,co,k,s,act", [
    (2, 24, 24, 3, 16, 3, 2, "silu"),    # the YOLO stem (Ci 3)
    (1, 20, 12, 3, 32, 3, 2, "gelu"),    # TinyViT's stem1, W 12
    (1, 9, 12, 8, 16, 3, 1, "none"),     # W 12, odd H
    (2, 7, 12, 6, 8, 2, 1, "silu"),      # k 2 at W 12
    (1, 11, 13, 16, 24, 3, 2, "silu"),   # odd H and W at stride 2
])
def test_conv2d_act_geometries_the_tpu_gate_refuses(b, h, w_, ci, co, k, s, act):
    """The port takes what ``conv2d_supported`` sends to XLA (W % 16 != 0,
    Ci = 3): against ``lax.conv_general_dilated``."""
    assert not jconv.conv2d_supported((b, h, w_, ci), k, s, k2_s2d=(k == 2))
    rng = np.random.default_rng(h * w_ + ci)
    x = rng.normal(size=(b, h, w_, ci)).astype(np.float32)
    w = (rng.normal(size=(k, k, ci, co)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    got = conv2d_act(_t(x), _t(w), _t(bias), k, s, act).numpy()
    np.testing.assert_allclose(got, _jax_ref(x, w, bias, k, s, act), atol=3e-5, rtol=1e-4)


def test_conv2d_act_channel_slice_and_zero_bias():
    """A C2f half (a channel slice, pixel stride 2c) and a None bias (the
    necks) give what a contiguous copy and a zero bias give."""
    rng = np.random.default_rng(8)
    y = _t(rng.normal(size=(2, 8, 8, 32)))
    w = _t(rng.normal(size=(3, 3, 16, 16)) * 0.1)
    half = y[..., 16:]
    assert not half.is_contiguous()
    got = conv2d_act(half, w, None, 3, 1, "none")
    want = conv2d_act_plain(half.contiguous(), w, torch.zeros(16), 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_conv2d_act_refuses_what_k17_does_not_compute():
    x, w3, b = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8), torch.zeros(8)
    w2 = torch.zeros(2, 2, 4, 8)
    with pytest.raises(ValueError, match="stride"):
        conv2d_act(x, w2, b, k=2, stride=2)
    with pytest.raises(ValueError, match="k in"):
        conv2d_act(x, torch.zeros(4, 4, 4, 8), b, k=4)
    with pytest.raises(ValueError, match="act"):
        conv2d_act(x, w3, b, k=3, act="relu")
    with pytest.raises(ValueError, match="does not fit"):
        conv2d_act(x, w2, b, k=3)
    with pytest.raises(ValueError, match="stride"):
        conv2d_act_plain(x, w3, b, 3, stride=3)


@pytest.mark.parametrize("k,ci,co", [(3, 256, 256), (3, 32, 16), (3, 64, 80), (2, 8, 128)])
def test_conv_weight_matrix_pads_for_the_kernels_boxes(k, ci, co):
    """The main kernel's weight matrix: w as (k k Ci, Co), zero-padded to at
    least 64 rows and a multiple of 64 columns; w's own storage when it
    needs no padding."""
    w = _t(np.random.default_rng(co).normal(size=(k, k, ci, co)))
    mat = conv_weight_matrix(w)
    rows, cols = max(k * k * ci, 64), -(-co // 64) * 64
    assert mat.shape == (rows, cols) and mat.is_contiguous()
    assert torch.equal(mat[:k * k * ci, :co], w.reshape(-1, co))
    assert not mat[k * k * ci:].any() and not mat[:, co:].any()
    assert (mat.data_ptr() == w.data_ptr()) == (rows == k * k * ci and cols == co)


def _yolo_tree(seed, cfg):
    """Init tree with random biases (the init's zeros hide bias bugs)."""
    tree = init_yolo_params(seed, cfg)
    rng = np.random.default_rng(seed + 50)

    def fill(node):
        if isinstance(node, list):
            for item in node:
                fill(item)
        elif "w" in node:
            node["b"] = (0.1 * rng.normal(size=node["b"].shape)).astype(np.float32)
        else:
            for v in node.values():
                fill(v)

    fill(tree)
    return tree


def test_yolo_fused_route_matches_jax(forced):
    """YOLOv8n with every dense conv on ``conv2d_act`` against the JAX
    forward with the gate forced, 64 x 64 inputs; the plain oracle agrees."""
    cfg = YoloConfig(num_classes=1)
    tree = _yolo_tree(2, cfg)
    rng = np.random.default_rng(7)
    img = rng.random((2, 64, 64, 3)).astype(np.float32)
    yolo, _ = from_jax_params(tree, None, "cpu", yolo_config=cfg, conv2d_fused=True)
    # the bridge keeps HWIO for conv2d_act
    np.testing.assert_array_equal(yolo.stem.weight.numpy(), tree["backbone"]["stem"]["w"])
    with torch.no_grad():
        got = yolo(_t(img))
        plain = yolo(_t(img), plain=True)
    want = jyolo.yolo_forward(tree, jnp.asarray(img), JaxYoloConfig(num_classes=1))
    for g, p, w in zip(got, plain, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-2)
        np.testing.assert_allclose(p.numpy(), g.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fused,calls", [(True, 39), (False, 0)])
def test_yolo_reaches_conv2d_act_39_times(monkeypatch, fused, calls):
    """YOLOv8n has 39 dense 3x3 convs a forward: 17 in the backbone, 10 in
    the head, 12 in the detect towers. With the option each reaches
    ``conv2d_act``; without it none does, and the default route's output
    is the fused route's."""
    seen = []

    def spy(x, w, b, k=3, stride=1, act="none"):
        seen.append(k)
        return conv2d_act(x, w, b, k, stride, act)

    monkeypatch.setattr(tyolo, "conv2d_act", spy)
    cfg = YoloConfig(num_classes=1)
    tree = _yolo_tree(3, cfg)
    img = _t(np.random.default_rng(9).random((1, 64, 64, 3)))
    with torch.no_grad():
        got = YoloV8(tree, cfg, conv2d_fused=fused)(img)
        assert sum(k > 1 for k in seen) == calls
        other = YoloV8(tree, cfg, conv2d_fused=not fused)(img)
    for g, o in zip(got, other):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-4, rtol=1e-4)


def test_tinyvit_fused_route_matches_jax(forced):
    """TinyViT at image 128 with its stems and neck on ``conv2d_act`` (stem1's
    GELU in the epilogue) against ``tinyvit_encoder(fused=False)`` with the
    gate forced (stem2 on the Pallas kernel there)."""
    cfg = TinyViTConfig(image_size=128)
    tree = _rand_tinyvit_tree(4, cfg)
    pix = (np.random.default_rng(11).normal(size=(1, 128, 128, 3)) * 0.2).astype(np.float32)
    enc = TinyViT(tree, cfg, conv2d_fused=True)
    with torch.no_grad():
        got = enc(_t(pix)).numpy()
        default = TinyViT(tree, cfg)(_t(pix)).numpy()
    want = np.asarray(jtv.tinyvit_encoder(tree, jnp.asarray(pix), jtv.TinyViTConfig(
        image_size=128), fused=False))
    assert got.shape == want.shape == (1, 8, 8, 256)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=1e-2)
    np.testing.assert_allclose(got, default, atol=1e-4 * np.abs(default).max(), rtol=0)


def test_vit_neck_fused_route_matches_jax(forced):
    """The ViT encoder at ``sam_tiny_test()`` widths on a 16 x 16 grid (image
    128: the narrowest grid the TPU kernel takes) with its neck's 3x3 on
    ``conv2d_act`` (no bias) against the JAX encoder, whose neck takes the
    Pallas kernel with the gate forced (zero bias)."""
    cfg = dataclasses.replace(sam_tiny_test(), image_size=128)
    assert jconv.conv2d_supported((2, 16, 16, cfg.output_channels), 3, 1)
    tree = _tiny_sam_tree(cfg=cfg)
    rng = np.random.default_rng(12)
    pix = rng.normal(size=(2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    sam = SamModel(tree, cfg, conv2d_fused=True)
    assert sam.vision.neck_conv2.shape == tree["vision"]["neck"]["conv2_w"].shape  # HWIO
    with torch.no_grad():
        got = sam.vision(_t(pix)).numpy()
        plain = sam.vision(_t(pix), plain=True).numpy()
    want = np.asarray(jsam.sam_image_encoder(tree, jnp.asarray(pix), cfg))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got, plain)


def test_pipeline_fused_route_matches_jax(forced):
    """The CPU engine with ``PipelineOptions(conv2d_fused=True)`` against the
    JAX pipeline with the gate forced (both built and called under it: the
    JAX engine traces its stages once per instance), the settings and
    frames of ``tests/test_torch_pipeline.py``."""
    rng = np.random.default_rng(0)
    frames = np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])
    jp = jengine.CellSegmentationPipeline(
        sam_config=jax_tiny(), yolo_config=JaxYoloConfig(num_classes=1), seed=0,
        options=jengine.PipelineOptions(compute_dtype=jnp.float32, **OPTS))
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, conv2d_fused=True, **OPTS))
    jo, to = jp.process_batch_arrays(frames), tp.process_batch_arrays(frames)
    assert tp._stages(64, 64)["yolo"].stem.fused
    np.testing.assert_array_equal(to["valid"], jo["valid"])
    assert jo["valid"].sum() > 0
    np.testing.assert_allclose(to["boxes"], jo["boxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(to["scores"], jo["scores"], rtol=1e-5, atol=1e-5)
    h, w = frames.shape[1:3]
    with torch.inference_mode():
        emb = tp._stages(h, w)["embed"](torch.from_numpy(frames))
    jst = jp._stages(h, w)
    jemb = jst["embed"](jst["sam_params"], jnp.asarray(frames))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-4, atol=1e-4)
    assert (to["mask_crops"] == jo["mask_crops"]).mean() >= 0.995


def test_pipeline_option_defaults_off():
    assert tengine.PipelineOptions().conv2d_fused is False
    tp = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS))
    st = tp._stages(64, 64)
    assert not st["yolo"].stem.fused and not st["sam"].vision.conv2d_fused


def test_tinyvit_init_tree_through_fused_bridge():
    """A MobileSAM-style tree (``"tinyvit"`` subtree) through the bridge with
    the option: TinyViT built with HWIO stems and neck."""
    cfg = sam_tiny_test()
    tree = {k: v for k, v in _tiny_sam_tree(cfg=cfg).items() if k != "vision"}
    tree["tinyvit"] = init_tinyvit_params(1, TinyViTConfig(image_size=cfg.image_size))
    _, sam = from_jax_params(None, tree, "cpu", torch.float32, sam_config=cfg,
                             conv2d_fused=True)
    tv = sam.vision
    assert isinstance(tv, TinyViT) and tv.conv2d_fused
    np.testing.assert_array_equal(tv.stem1_w.numpy(), tree["tinyvit"]["stem1"]["w"])
    np.testing.assert_array_equal(tv.neck_conv2.numpy(), tree["tinyvit"]["neck"]["conv2_w"])
