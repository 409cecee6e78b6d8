"""SAM 2 in the port (``models/sam/hiera.py``, the engine's SAM 2 stages)
against the plain fp32 reference (``tests/plain_sam2.py``), seeded, on the
CPU at ``sam2_tiny_test()``: the trunk, the neck and the decoder's masks,
a pooling block and a global block alone, the attention's plain version
against SDPA at every attention case of the tiny and the published
configurations, the stability choice on built cases, the box prompt, the engine's windowed head against the whole masks,
its spans, and the benchmark's copy of the reference against this one.

Both sides run in fp32 on the CPU, so each tolerance is fp32 rounding
through a different order of operations (SDPA against an explicit softmax,
the GEMMs' LayerNorm prologue against ``F.layer_norm``, NHWC against NCHW
convolutions): relative to the tensor's largest value, 1e-5 after a block
and 1e-4 after the whole trunk or decoder (a few dozen such steps)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_sam2 as plain
from synth import make_cell_image
from yolo_sam_inference_tpu_torch.models.sam import (
    Sam2Model,
    init_sam2_params,
    sam2_1_hiera_l,
    sam2_tiny_test,
)
from yolo_sam_inference_tpu_torch.models.sam.hiera import HieraBlock
from yolo_sam_inference_tpu_torch.ops.hiera_attention import hiera_window_attention_plain
from yolo_sam_inference_tpu_torch.ops.window_crop import crop_sample
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.utils import spans

torch.set_num_threads(2)

CFG = sam2_tiny_test()
REPO = Path(__file__).resolve().parents[1]


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return None if tree is None else torch.as_tensor(np.asarray(tree, np.float32))


def _close(got, want, rel):
    got, want = got.float(), want.float()
    scale = want.abs().max().clamp(min=1e-6)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float((got - want).abs().max() / scale)
    assert err <= rel, f"max error {err:.3g} of the largest value, limit {rel}"


@pytest.fixture(scope="module")
def model():
    tree = init_sam2_params(3, CFG)
    return _t(tree), Sam2Model(tree, CFG).eval()


@pytest.fixture(scope="module")
def pix():
    return torch.randn(2, CFG.image_size, CFG.image_size, 3,
                       generator=torch.Generator().manual_seed(5))


def test_published_config_blocks():
    """Hiera-L's blocks as the yaml gives them: stage ends 1 / 7 / 43 / 47,
    pooling at 2 / 8 / 44, widths 144 to 1152, head dim 72 everywhere, the
    transition blocks on the previous stage's window, globals 23 / 33 / 43."""
    cfg = sam2_1_hiera_l()
    blocks = cfg.blocks()
    assert cfg.stage_ends == (1, 7, 43, 47) and cfg.q_pool_blocks == (2, 8, 44)
    assert {d // h for _, d, h, _, _ in blocks} == {72}
    assert [blocks[i][3] for i in (0, 2, 3, 8, 9, 23, 33, 43, 44, 45)] == [8, 8, 4, 4, 16, 0, 0, 0,
                                                                          16, 8]
    assert [i for i, b in enumerate(blocks) if b[4]] == [2, 8, 44]
    assert cfg.stage_dims == (144, 288, 576, 1152) and cfg.grid_size == 64


def test_trunk_matches_plain(model, pix):
    tree, sam = model
    with torch.inference_mode():
        want = plain.trunk(tree["vision"], CFG, pix.permute(0, 3, 1, 2))
        enc = sam.vision
        got = enc.stages(enc.patch_embed(pix), 0, len(enc.blocks))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


def test_neck_matches_plain(model, pix):
    tree, sam = model
    with torch.inference_mode():
        xs = plain.trunk(tree["vision"], CFG, pix.permute(0, 3, 1, 2))
        want = plain.neck(tree["vision"], CFG, xs)
        got = sam.vision.neck(xs)
    for g, w in zip(got, want):
        _close(g, w.permute(0, 2, 3, 1), 1e-5)


@pytest.mark.parametrize("index", [1, 4], ids=["pooling", "global"])
def test_block_alone_matches_plain(model, index):
    """Block 1 (stage 2's first: width 16 -> 32, queries and shortcut pooled
    in windows of 4) and block 4 (global attention over the 4 x 4 grid)."""
    tree, sam = model
    dim, dim_out, heads, window, pool = CFG.blocks()[index]
    side = CFG.trunk_grid >> sum(1 for b in CFG.blocks()[:index] if b[4])
    x = torch.randn(2, side, side, dim, generator=torch.Generator().manual_seed(index))
    blk = sam.vision.blocks[index]
    assert isinstance(blk, HieraBlock) and (blk.pool, blk.window) == (pool, window)
    with torch.inference_mode():
        got = blk(x)
        want = plain.block(x, tree["vision"]["blocks"][index], dim, dim_out, heads, window, pool)
    assert got.shape == (2, side // 2 if pool else side, side // 2 if pool else side, dim_out)
    _close(got, want, 1e-5)


def _sdpa_windows(qkv, heads, window, pool):
    """The oracle: each window's q, k, v gathered by permutes (q max-pooled
    2 x 2 by ``F.max_pool2d``), ``F.scaled_dot_product_attention`` in fp32,
    scattered back into token order."""
    import torch.nn.functional as F

    b, s, _, c3 = qkv.shape
    c = c3 // 3
    hd, w = c // heads, window or s
    n, wq = s // w, (w // 2 if pool else w)
    t = qkv.float().reshape(b, n, w, n, w, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    k, v = (t[i].reshape(b * n * n, heads, w * w, hd) for i in (1, 2))
    q = t[0].reshape(-1, w, w, hd)
    if pool:
        q = F.max_pool2d(q.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    o = F.scaled_dot_product_attention(q.reshape(b * n * n, heads, wq * wq, hd), k, v)
    o = o.reshape(b, n, n, heads, wq, wq, hd).permute(0, 1, 4, 2, 5, 3, 6)
    return o.reshape(b, n * wq, n * wq, c)


def _case_id(grid, window, pool):
    return f"g{grid}-{f'w{window}' if window else 'global'}{'-pooled' if pool else ''}"


def _attention_cases():
    """(id, batch, grid, heads, hd, window, pool, 4C rows): every attention of
    ``sam2_tiny_test()`` at its grid, and each case of Hiera-L's
    ``attention()`` (hd 72) at batch 1 on a grid cut to two windows a side
    (a global block's to 16 x 16), its first pooled case also with the
    pooling block's [qkv | shortcut] rows 4C apart."""
    cases = []
    for i, ((_, dim_out, *_), (grid, heads, window, pool)) in enumerate(
            zip(CFG.blocks(), CFG.attention())):
        cases.append((f"tiny{i}", 2, grid, heads, dim_out // heads, window, pool, pool))
    hiera_l = list(dict.fromkeys(sam2_1_hiera_l().attention()))
    for grid, heads, window, pool in hiera_l:
        cases.append((f"hiera-l-{_case_id(grid, window, pool)}", 1, 2 * window or 16, heads, 72,
                      window, pool, False))
    grid, heads, window, _ = next(c for c in hiera_l if c[3])
    cases.append((f"hiera-l-{_case_id(grid, window, True)}-4c-rows", 1, 2 * window, heads, 72,
                  window, True, True))
    return cases


@pytest.mark.parametrize("case", _attention_cases(), ids=lambda c: c[0])
def test_attention_plain_matches_sdpa(case):
    """``hiera_window_attention_plain`` (explicit fp32 softmax) against the
    SDPA oracle; where rows are 4C apart, qkv is the first 3C columns of a
    (tokens, 4C) product, as at a pooling block."""
    _, b, s, heads, hd, window, pool, wide = case
    c = heads * hd
    g = torch.Generator().manual_seed(s * heads + window)
    y = torch.randn(b * s * s, (4 if wide else 3) * c, generator=g)
    qkv = y[:, :3 * c].reshape(b, s, s, 3 * c)
    assert qkv.stride(2) == y.shape[1]
    with torch.inference_mode():
        got = hiera_window_attention_plain(qkv, heads, window, pool)
        want = _sdpa_windows(qkv, heads, window, pool)
    side = s // 2 if pool else s
    assert got.shape == (b, side, side, c)
    _close(got, want, 1e-5)


def test_decoder_matches_plain(model, pix):
    """The chosen low-res masks, their tokens and IoU, on the plain
    features, for boxes anywhere on the canvas."""
    tree, sam = model
    boxes = torch.tensor([[[4.0, 6.0, 30.0, 41.0], [20.0, 3.0, 60.0, 22.0], [0.0, 0.0, 63.0, 63.0]],
                          [[10.0, 12.0, 15.0, 18.0], [33.0, 40.0, 57.0, 62.0],
                           [2.0, 50.0, 9.0, 60.0]]])
    with torch.inference_mode():
        feats = plain.encode(tree, CFG, pix)
        want = plain.segment(tree, CFG, feats, boxes)
        emb, s1, s0 = (f.permute(0, 2, 3, 1).contiguous() for f in feats)
        got = sam.low_res_masks(emb, s1, s0, sam.box_prompts(boxes))
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    _close(got[0], want[0], 1e-4)
    _close(got[2], want[2], 1e-5)


def test_box_prompts_are_corner_points(model):
    """A box is its corners as points labelled 2 and 3 and a padding point."""
    tree, sam = model
    boxes = torch.tensor([[[3.0, 7.0, 40.0, 51.0]], [[0.0, 0.0, 63.0, 63.0]]])
    with torch.inference_mode():
        got = sam.box_prompts(boxes)
    want = plain.embed_boxes(tree, CFG, boxes.reshape(-1, 4)).reshape(2, 1, 3, -1)
    _close(got, want, 1e-6)


def _logits(n_pos, n_band, n_neg, side=10):
    """One low-res mask: n_pos pixels at 5, n_band at 0.01 (inside +-delta),
    the rest at -5."""
    v = torch.full((side * side,), -5.0)
    v[:n_pos] = 5.0
    v[n_pos:n_pos + n_band] = 0.01
    assert n_pos + n_band + n_neg == side * side
    return v


@pytest.mark.parametrize("case,logits0,token", [
    ("stable", _logits(98, 2, 0), 0),  # 98 / 100 = 0.98: kept
    ("unstable", _logits(97, 3, 0), 2),  # 0.97: the best of 1.. by IoU
    ("no_pixel_above", _logits(0, 0, 100), 0),  # area above -delta 0: stability 1
    ("half_in_band", _logits(30, 30, 40), 2),
], ids=lambda v: v if isinstance(v, str) else "")
def test_stability_choice(model, case, logits0, token):
    """Token 0 where its stability reaches 0.98, else the best of tokens 1..
    by IoU (here token 2), in the port and in the plain reference."""
    tree, sam = model
    iou = torch.tensor([[0.9, 0.1, 0.7, 0.3]])
    got = sam.choose(logits0[None], iou)
    masks = torch.stack([logits0.reshape(10, 10)] + [torch.zeros(10, 10)] * 3)[None]
    _, want, _ = plain.single_mask(CFG, masks, iou)
    assert int(got) == int(want) == token, case


def _pipe(**opts):
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=CFG, yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, batch_size=2, yolo_size=64,
                                        max_det=4, metric_crop=24, nms_candidates=64, **opts))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(4)
    return np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])


def test_segment_stage_matches_whole_masks(frames):
    """The engine's SAM 2 segment stage (the chosen token's logits on each
    prompt's window, sampled onto its crop) equals sampling each prompt's
    whole chosen low-res mask, for the engine's own boxes, and gives the
    same chosen tokens; the batch path hands them on as ``mask_token``."""
    pipe = _pipe()
    st = pipe._stages(64, 64)
    sam, scfg, opts = st["sam"], st["scfg"], pipe.options
    with torch.inference_mode():
        img = torch.as_tensor(frames)
        boxes, _, valid = st["detect"](img)
        feats = st["embed"](img)
        crops, offs, token = st["segment"](feats, boxes, valid)
        scale = scfg.image_size / 64
        low, chosen, _ = sam.low_res_masks(*feats, sam.box_prompts(boxes * scale))
        b, k = boxes.shape[:2]
        full = crop_sample(
            low.reshape(b * k, *low.shape[-2:]), offs.reshape(b * k, 2),
            torch.zeros(b * k, 2, dtype=torch.long), 24,
            scale * 4 * scfg.grid_size / scfg.image_size)
    want = (full.reshape(b, k, 24, 24) > 0) & valid[..., None, None]
    assert valid.any()
    assert torch.equal(crops, want)
    assert torch.equal(token, torch.where(valid, chosen, -1))
    out = pipe.process_batch_arrays(frames)
    assert np.array_equal(out["mask_token"], token.numpy())
    assert "mask_token" not in out["metrics"]


def test_engine_refuses_what_sam2_lacks(frames):
    with pytest.raises(ValueError, match="SAM 2"):
        _pipe(quant="int8")
    with pytest.raises(ValueError, match="square"):
        _pipe().process_batch_arrays(frames[:, :, :48])


def test_spans_nest_under_their_stages(frames):
    """With recording on, ``hiera_fine`` and ``hiera_coarse`` lie inside
    ``embed`` and ``sam2_head`` inside ``segment``, one each a batch; the
    synchronised path times them under their own keys, within their stage's
    time. Off, no span is kept and the outputs are the same bits."""
    pipe = _pipe()
    off = pipe._fetch_outputs(pipe._dispatch_batch(frames))
    with spans.recording() as rec:
        on = pipe._fetch_outputs(pipe._dispatch_batch(frames))
    names = {s.name: rec.spans[s.parent].name for s in rec.spans if s.parent is not None}
    assert names["hiera_fine"] == names["hiera_coarse"] == "embed"
    assert names["sam2_head"] == "segment"
    assert [s.name for s in rec.spans].count("sam2_head") == 1
    for key in ("boxes", "mask_crops", "offsets"):
        assert np.array_equal(off[key], on[key])
    assert spans.span("hiera_fine") is spans.OFF
    timings = {}
    pipe.process_batch_arrays(frames, timings)
    assert timings["hiera_fine"] + timings["hiera_coarse"] <= timings["sam_preprocess"]
    assert timings["sam2_head"] <= timings["sam_inference_total"]


def test_reference_copies_agree(model, pix):
    """The benchmark's reference (``cytobench/reference/sam2.py`` through its
    family) and this one on one tiny batch: the features and each box's
    chosen low-res mask. The family reads the configuration's yaml-named
    groups; here they hold the tiny sizes."""
    from cytobench.families import sam2_hiera as fam
    from cytobench.reference import sam2 as ref

    tree, _ = model
    cfg = json.loads((REPO / "cytobench" / "configs" / "sam2.1-hiera-l.json").read_text())
    cfg["image_size"] = CFG.image_size
    cfg["trunk"].update(embed_dim=CFG.embed_dim, num_heads=CFG.num_heads, stages=list(CFG.stages),
                        global_att_blocks=list(CFG.global_att_blocks),
                        window_pos_embed_bkg_spatial_size=[CFG.pos_embed_bkg] * 2,
                        window_spec=list(CFG.window_spec))
    cfg["neck"].update(d_model=CFG.output_channels,
                       backbone_channel_list=list(reversed(CFG.stage_dims)))
    cfg["prompt_encoder"].update(embed_dim=CFG.prompt_hidden)
    cfg["mask_decoder"].update(transformer_dim=CFG.prompt_hidden, num_heads=CFG.decoder_heads,
                               mlp_dim=CFG.decoder_mlp_dim, iou_head_hidden_dim=CFG.iou_head_hidden)
    assert fam.port_config(cfg) == CFG
    boxes = torch.tensor([[4.0, 6.0, 30.0, 41.0], [10.0, 12.0, 15.0, 18.0]])
    with torch.inference_mode():
        want = plain.encode(tree, CFG, pix)
        got = ref.encoder(tree["vision"], cfg, pix)
        for g, w in zip(got, want):
            _close(g, w.permute(0, 2, 3, 1), 1e-4)
        hyper, iou, keys = ref.decode(tree, got[0], ref.box_tokens(tree, boxes, CFG.image_size),
                                      CFG.decoder_heads, CFG.decoder_layer_norm_eps)
        low, token = ref.single_mask(ref.mask_logits(tree, keys, got[1], got[2], hyper), iou,
                                     CFG.stability_delta, CFG.stability_thresh)
        wmask, wtoken, _ = plain.segment(tree, CFG, want, boxes[:, None])
    assert torch.equal(token, wtoken[:, 0])
    _close(low, wmask[:, 0], 1e-4)
