"""The port's models and preprocessing against the JAX package, on the CPU.

Same numpy inputs and the same parameter trees through both, in fp32. The
port's numpy init must reproduce the JAX package's init leaf for leaf, so
one seed gives the same weights on a machine that has no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_sam_inference_tpu.models import sam as jsam_pkg
from yolo_sam_inference_tpu.models import yolo as jyolo_pkg
from yolo_sam_inference_tpu.models.sam import convert as jconvert
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.ops import nms as jnms
from yolo_sam_inference_tpu.ops import preprocess as jpre
from yolo_sam_inference_tpu_torch.models.sam import (
    SamModel,
    adapt_resolution,
    init_sam_params,
    sam_tiny_test,
)
from yolo_sam_inference_tpu_torch.models.yolo import (
    YoloConfig,
    decode_predictions,
    init_yolo_params,
)
from yolo_sam_inference_tpu_torch.ops import nms, preprocess
from yolo_sam_inference_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same_tree(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if x is None or y is None:
            assert x is None and y is None, path
            continue
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=path)


@pytest.mark.parametrize("seed", [0, 7])
def test_sam_init_matches_jax_bitwise(seed):
    cfg = sam_tiny_test()
    _assert_same_tree(init_sam_params(seed, cfg), jsam_pkg.init_sam_params(seed, cfg))


@pytest.mark.parametrize("seed", [0, 3])
def test_yolo_init_matches_jax_bitwise(seed):
    cfg = YoloConfig(num_classes=1)
    _assert_same_tree(init_yolo_params(seed, cfg), jyolo_pkg.init_yolo_params(seed, cfg))


def _tiny_sam_tree(seed=1, cfg=None):
    """Init tree with nonzero rel-pos tables and pos-embed (zeros hide bugs)."""
    cfg = cfg or sam_tiny_test()
    tree = init_sam_params(seed, cfg)
    rng = np.random.default_rng(seed + 100)
    vis = tree["vision"]
    vis["pos_embed"] = (0.1 * rng.normal(size=vis["pos_embed"].shape)).astype(np.float32)
    for lp in vis["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            shape = lp["attn"][key].shape
            lp["attn"][key] = (0.3 * rng.normal(size=shape)).astype(np.float32)
    return tree


def test_adapt_resolution_matches_jax():
    base = sam_tiny_test()
    tree = _tiny_sam_tree(cfg=base)
    to = dataclasses.replace(base, image_size=128, window_size=4)  # grid 16
    _assert_same_tree(adapt_resolution(tree, to), jconvert.adapt_resolution(tree, to))


def test_bridge_layouts():
    cfg = sam_tiny_test()
    tree = _tiny_sam_tree(cfg=cfg)
    ytree = init_yolo_params(0, YoloConfig(num_classes=1))
    yolo, sam = from_jax_params(ytree, tree, "cpu", torch.float32,
                                yolo_config=YoloConfig(num_classes=1), sam_config=cfg)
    # conv weights HWIO -> OIHW; linear weights keep (in, out)
    np.testing.assert_array_equal(yolo.stem.weight.numpy(),
                                  ytree["backbone"]["stem"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sam.vision.layers[0].qkv.w.numpy(),
                                  tree["vision"]["layers"][0]["attn"]["qkv"]["w"])
    _, sam16 = from_jax_params(None, tree, "cpu", torch.bfloat16, sam_config=cfg)
    assert all(p.dtype == torch.bfloat16 for p in sam16.parameters())
    with pytest.raises(ValueError):
        from_jax_params(None, tree, "cpu")


@pytest.mark.parametrize("h,w,size", [(64, 64, 64), (48, 80, 64), (96, 128, 64), (30, 40, 64)])
def test_letterbox_matches_jax(h, w, size):
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, size=(2, h, w, 3), dtype=np.uint8)
    got, r, pad = preprocess.letterbox_batch(torch.from_numpy(img), size)
    want, jr, jpad = jpre.letterbox_batch(jnp.asarray(img), size)
    assert r == jr and pad == jpad
    # jax.image.resize's antialiased triangle filter, same weights in fp32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sam_preprocess_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(2, 48, 40, 3), dtype=np.uint8)
    got, r, hw = preprocess.sam_preprocess_batch(torch.from_numpy(img), 64)
    want, jr, jhw = jpre.sam_preprocess_batch(jnp.asarray(img), 64)
    assert r == jr and hw == jhw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_box_mappings_match_jax():
    """``scale_boxes_from_letterbox`` and ``boxes_to_sam_coords`` (JAX
    ``ops/preprocess.py:73-87``): a letterboxed box back to the frame, then
    to the SAM canvas, in fp32."""
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0, 640, size=(2, 7, 4)).astype(np.float32)
    for scale, pad, sam_scale in ((0.625, (0, 80), 1024 / 512), (1.25, (16, 0), 0.5)):
        got = preprocess.scale_boxes_from_letterbox(torch.from_numpy(boxes), scale, pad)
        want = jpre.scale_boxes_from_letterbox(jnp.asarray(boxes), scale, pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
        got = preprocess.boxes_to_sam_coords(got, sam_scale)
        want = jpre.boxes_to_sam_coords(want, sam_scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape,out_hw,dtype", [
    ((2, 3, 32, 32), (128, 128), np.float32),  # the mask head's 4x upsample
    ((5, 17, 23), (40, 31), np.float32),       # odd sizes, both ways up
    ((3, 64, 48), (20, 48), np.float32),       # a shrink (antialiased) and an identity axis
    ((2, 9, 9), (9, 9), np.float32),           # the identity
    ((4, 12, 10), (36, 25), bool)])            # bool masks come out fp32
def test_upsample_masks_bilinear_matches_jax(shape, out_hw, dtype):
    """``upsample_masks_bilinear`` (JAX ``ops/preprocess.py:90-95``):
    ``jax.image.resize``'s half-pixel bilinear on the last two axes."""
    rng = np.random.default_rng(sum(shape))
    masks = rng.normal(size=shape).astype(np.float32)
    masks = masks > 0 if dtype is bool else masks
    got = preprocess.upsample_masks_bilinear(torch.from_numpy(masks), *out_hw)
    want = np.asarray(jpre.upsample_masks_bilinear(jnp.asarray(masks), *out_hw))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape == shape[:-2] + out_hw
    # the same triangle weights in fp32, summed in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_batched_nms_matches_jax():
    rng = np.random.default_rng(4)
    b, n = 3, 200
    xy = rng.uniform(0, 60, size=(b, n, 2))
    wh = rng.uniform(4, 20, size=(b, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    # distinct scores with clear margins: no ties in top-k or the greedy order
    scores = np.stack([rng.permutation(n) for _ in range(b)]).astype(np.float32) / n
    got = nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), max_det=16,
                          iou_threshold=0.5, conf_threshold=0.3, num_candidates=64)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), max_det=16,
                            iou_threshold=0.5, conf_threshold=0.3, num_candidates=64)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[2].sum() > 4  # some suppressed, some kept


def test_yolo_forward_and_decode_match_jax():
    cfg = YoloConfig(num_classes=1)
    tree = init_yolo_params(5, cfg)
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    yolo, _ = from_jax_params(tree, None, "cpu", yolo_config=cfg)
    with torch.no_grad():
        outs = yolo(torch.from_numpy(img))
    jouts = jyolo_pkg.yolo_forward(tree, jnp.asarray(img), cfg)
    for o, jo in zip(outs, jouts):
        assert tuple(o.shape) == jo.shape
        # fp32 convolutions in another summation order, ~20 layers deep
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-3, atol=1e-3)
    boxes, scores = decode_predictions([torch.from_numpy(np.array(j)) for j in jouts], cfg)
    jb, js = jyolo_pkg.decode_predictions(jouts, cfg)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_sam():
    cfg = sam_tiny_test()
    tree = _tiny_sam_tree(cfg=cfg)
    return cfg, tree, SamModel(tree, cfg)


def test_sam_encoder_matches_jax(tiny_sam):
    cfg, tree, sam = tiny_sam
    rng = np.random.default_rng(6)
    pix = rng.normal(size=(2, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    with torch.no_grad():
        got = sam.vision(torch.from_numpy(pix)).numpy()
    want = jsam.sam_image_encoder(tree, jnp.asarray(pix), cfg)
    assert got.shape == want.shape == (2, cfg.grid_size, cfg.grid_size, cfg.output_channels)
    # fp32; the JAX CPU path partitions windows, the port keeps the grid
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_sam_prompt_decoder_and_head_match_jax(tiny_sam):
    cfg, tree, sam = tiny_sam
    rng = np.random.default_rng(7)
    b, k = 2, 3
    emb = rng.normal(size=(b, cfg.grid_size, cfg.grid_size, cfg.output_channels)).astype(np.float32)
    xy = rng.uniform(0, 40, size=(b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, size=(b, k, 2))], -1).astype(np.float32)

    with torch.no_grad():
        sparse = sam.prompt.boxes(torch.from_numpy(boxes))
        iou, hyper, keys = sam.mask_decoder_tokens(torch.from_numpy(emb), sparse)
        logits = sam.decoder.mask_head(keys[:, 2:6, 1:5], hyper[:, :1])
    jsparse = jsam.sam_prompt_boxes(tree, jnp.asarray(boxes), cfg)
    # fp32 Fourier features, sine arguments up to ~100 rad
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse), rtol=1e-5, atol=1e-4)
    jiou, jhyper, jkeys = jsam.sam_mask_decoder_tokens(tree, jnp.asarray(emb), jsparse, cfg)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hyper.numpy(), np.asarray(jhyper), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(keys.numpy(), np.asarray(jkeys), rtol=1e-4, atol=1e-4)
    jlogits = jsam.sam_mask_head(tree, jkeys[:, 2:6, 1:5], jhyper[:, :1])
    assert logits.shape == jlogits.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
