"""SAM's prompt API in the port against the JAX package, on the CPU: point
prompts, multimask output, dense prompts, and the decoder at prompt-token
counts above the box prompt's 7.

The same numpy inputs and the same seeded tree go through the JAX functions
(``sam_prompt_points``, ``sam_mask_decoder``, ``sam_forward_boxes``,
``sam_mask_decoder_tokens``) and their counterparts on ``SamModel``, in fp32
at ``sam_tiny_test()``. On the CPU the port's decoder takes its kernels'
plain versions; the JAX decoder runs its plain branch, and its fused branch
with the Pallas kernels in interpret mode (``_fused_i2t_enabled`` forced, as
``tests/test_torch_decoder.py`` does). The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``[prompts]``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu_torch.models.sam import SamModel, init_sam_params, sam_tiny_test

torch.set_num_threads(1)

# fp32 both sides; the decoder's summation orders differ (the bound the
# JAX package holds its fused branch to against its plain one)
TOL = dict(rtol=2e-4, atol=2e-4)


def _tree(seed: int = 3):
    """The seeded tree with the decoder's biases and LayerNorm affines drawn
    at random (zeros would hide a bias applied in the wrong place)."""
    cfg = sam_tiny_test()
    tree = init_sam_params(seed, cfg)
    rng = np.random.default_rng(seed + 100)

    def draw(node):
        if isinstance(node, dict):
            for key, v in node.items():
                if key == "b" or key == "bias":
                    node[key] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
                elif key == "scale":
                    node[key] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                else:
                    draw(v)
        elif isinstance(node, list):
            for v in node:
                draw(v)

    draw(tree["decoder"])
    return cfg, tree


@pytest.fixture(scope="module")
def tiny():
    cfg, tree = _tree()
    return cfg, tree, SamModel(tree, cfg)


def _points(rng, cfg, b, k, p):
    """Points anywhere on the canvas, labels 1, 0 and -1 mixed."""
    pts = rng.uniform(0, cfg.image_size, size=(b, k, p, 2)).astype(np.float32)
    labels = rng.integers(-1, 2, size=(b, k, p)).astype(np.int32)
    return pts, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("pad", [True, False])
def test_points_match_jax(tiny, pad):
    """``SamPromptEncoder.points``: the Fourier encoding of (p + 0.5) / size,
    not-a-point at label -1, point_embed 0 / 1 added at labels 0 / 1; with
    ``pad`` one more padding point."""
    cfg, tree, sam = tiny
    rng = np.random.default_rng(1 + pad)
    pts, labels = _points(rng, cfg, 2, 3, 5)
    labels[0, 0] = [-1, 0, 1, 1, 0]  # each label at least once
    with torch.no_grad():
        got = sam.prompt.points(_t(pts), _t(labels), pad=pad)
    want = jsam.sam_prompt_points(tree, jnp.asarray(pts), jnp.asarray(labels), cfg, pad=pad)
    assert got.shape[-2] == 5 + int(pad)
    _close(got, want)
    # a padding point is the not-a-point embedding itself
    np.testing.assert_array_equal(got[0, 0, 0].numpy(), tree["prompt"]["not_a_point"])


@pytest.mark.parametrize("dense", ["none", "per-image", "shared"])
@pytest.mark.parametrize("multimask", [False, True])
def test_mask_decoder_matches_jax(tiny, multimask, dense):
    """``SamModel.mask_decoder`` against ``sam_mask_decoder``: masks 1.. and
    their IoU with ``multimask_output``, mask 0 without; the dense prompt
    (B, gs, gs, C) or (1, gs, gs, C) added to the embeddings, or the no-mask
    embedding."""
    cfg, tree, sam = tiny
    rng = np.random.default_rng(10 + 3 * multimask + len(dense))
    b, k, gs, c = 2, 3, cfg.grid_size, cfg.prompt_hidden
    emb = rng.normal(size=(b, gs, gs, c)).astype(np.float32)
    sparse = (0.3 * rng.normal(size=(b, k, 2, c))).astype(np.float32)
    dp = {"none": None, "per-image": (b, gs, gs, c), "shared": (1, gs, gs, c)}[dense]
    dp = None if dp is None else (0.5 * rng.normal(size=dp)).astype(np.float32)
    with torch.no_grad():
        masks, iou = sam.mask_decoder(_t(emb), _t(sparse), None if dp is None else _t(dp),
                                      multimask_output=multimask)
    jmasks, jiou = jsam.sam_mask_decoder(tree, jnp.asarray(emb), jnp.asarray(sparse), cfg,
                                         dense_prompts=None if dp is None else jnp.asarray(dp),
                                         multimask_output=multimask)
    m = cfg.num_mask_tokens - 1 if multimask else 1
    assert tuple(masks.shape) == (b, k, m, 4 * gs, 4 * gs) and tuple(iou.shape) == (b, k, m)
    _close(masks, jmasks)
    _close(iou, jiou)


@pytest.mark.parametrize("multimask", [False, True])
def test_forward_boxes_matches_jax(tiny, multimask):
    """``SamModel.forward_boxes`` (the module call) against
    ``sam_forward_boxes``: the encoder, the box prompts and the decoder."""
    cfg, tree, sam = tiny
    rng = np.random.default_rng(20 + multimask)
    b, k = 2, 3
    pix = rng.normal(size=(b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    xy = rng.uniform(0, 40, size=(b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, size=(b, k, 2))], -1).astype(np.float32)
    with torch.no_grad():
        masks, iou = sam.forward_boxes(_t(pix), _t(boxes), multimask_output=multimask)
        again = sam(_t(pix), _t(boxes), multimask_output=multimask)
    jmasks, jiou = jsam.sam_forward_boxes(tree, jnp.asarray(pix), jnp.asarray(boxes), cfg,
                                          multimask_output=multimask)
    _close(masks, jmasks)
    _close(iou, jiou)
    torch.testing.assert_close(again[0], masks, rtol=0, atol=0)


@pytest.mark.parametrize("branch", ["plain", "fused"])
@pytest.mark.parametrize("tq", [7, 9, 17, 34])
def test_decoder_with_points_matches_jax(tiny, monkeypatch, tq, branch):
    """The whole decoder on point prompts at tq = 5 + P + 1 tokens (P points
    and the padding point): 7 as a box's, 9 and 17 past one and two groups
    of 8, 34 as 28 points. Against the JAX decoder's plain branch, and its
    fused branch (K6, K7 in interpret mode)."""
    cfg, tree, sam = tiny
    rng = np.random.default_rng(30 + tq)
    b, k, gs, c = 2, 2, cfg.grid_size, cfg.prompt_hidden
    pts, labels = _points(rng, cfg, b, k, tq - 6)
    labels[..., 0] = 1  # a foreground point in every prompt
    emb = rng.normal(size=(b, gs, gs, c)).astype(np.float32)
    with torch.no_grad():
        sparse = sam.prompt.points(_t(pts), _t(labels))
        assert sparse.shape[-2] + cfg.num_mask_tokens + 1 == tq
        iou, hyper, keys = sam.mask_decoder_tokens(_t(emb), sparse)
        masks, miou = sam.mask_decoder(_t(emb), sparse, multimask_output=True)
    if branch == "fused":
        monkeypatch.setattr(jsam, "_fused_i2t_enabled", lambda c: True)
    jsparse = jsam.sam_prompt_points(tree, jnp.asarray(pts), jnp.asarray(labels), cfg)
    _close(sparse, jsparse)
    jiou, jhyper, jkeys = jsam.sam_mask_decoder_tokens(tree, jnp.asarray(emb), jsparse, cfg)
    for got, want in ((iou, jiou), (hyper, jhyper), (keys, jkeys)):
        _close(got, want)
    jmasks, jmiou = jsam.sam_mask_decoder(tree, jnp.asarray(emb), jsparse, cfg,
                                          multimask_output=True)
    _close(masks, jmasks)
    _close(miou, jmiou)


def test_box_and_points_concatenated_match_jax(tiny):
    """A box and 4 points of the same prompt, their tokens concatenated
    (``pad=False``, 11 tokens), as SAM takes a box with points."""
    cfg, tree, sam = tiny
    rng = np.random.default_rng(40)
    b, k, gs, c = 2, 3, cfg.grid_size, cfg.prompt_hidden
    xy = rng.uniform(0, 40, size=(b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, size=(b, k, 2))], -1).astype(np.float32)
    pts, labels = _points(rng, cfg, b, k, 4)
    emb = rng.normal(size=(b, gs, gs, c)).astype(np.float32)
    with torch.no_grad():
        sparse = torch.cat([sam.prompt.boxes(_t(boxes)),
                            sam.prompt.points(_t(pts), _t(labels), pad=False)], dim=2)
        masks, iou = sam.mask_decoder(_t(emb), sparse)
    jsparse = jnp.concatenate([jsam.sam_prompt_boxes(tree, jnp.asarray(boxes), cfg),
                               jsam.sam_prompt_points(tree, jnp.asarray(pts), jnp.asarray(labels),
                                                      cfg, pad=False)], axis=2)
    jmasks, jiou = jsam.sam_mask_decoder(tree, jnp.asarray(emb), jsparse, cfg)
    _close(masks, jmasks)
    _close(iou, jiou)
