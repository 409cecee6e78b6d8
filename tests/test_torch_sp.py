"""The port's sequence-parallel encoder and engine against the JAX package,
on the CPU.

One launch of four gloo ranks (``parallel.launch.run_ranks``, the rank
functions of ``parallel.workers``: they import neither jax nor this file)
runs every multi-rank case, ranks 0-1 over a group of their own for the
sp = 2 cases:

* the tiny SAM config (grid 8, window 2, one windowed and one global layer)
  at sp = 2 and sp = 4;
* SAM ViT-B widths (C 768, 12 heads) at grid 32, window 16, cut to 2 layers,
  at sp = 2;
* the tiny config at grid 28 and SAM's window of 14 at sp = 2: each rank's
  windows run on K12 at grid side 14 (the window attention kernel takes no
  window of 14), as the single-device flat route runs its windows;
* ``PipelineOptions(encoder_parallel="sp")`` on the tiny pipeline at sp = 2.

K12 as a global layer of the sequence-parallel encoder calls it (q a view
of the rank's own qkv, k and v views of the all-gathered k | v half, the
rank's first row ``row0``) is held here, in one process, against the JAX
package's Pallas kernel in interpret mode on the tables JAX
``parallel/sp.py:146-164`` builds.

The parent holds the ranks' results against JAX ``sam_image_encoder_sp`` on
the virtual CPU mesh (``tests/test_parallel.py:282-310``), the JAX and the
port's single-device encoders, and the port's single-device pipeline
(``test_parallel.py:409-441``). fp32 throughout, so the JAX einsum
branch's bf16 cast of the logits (``sp.py:174-177``) is a no-op.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synth import make_cell_image
from test_torch_offgrid import jax_relpos_attention
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.parallel.mesh import make_mesh_axes
from yolo_sam_inference_tpu.parallel.sp import sam_image_encoder_sp as jax_sp
from yolo_sam_inference_tpu_torch.models.sam import (
    SamImageEncoder,
    init_sam_params,
    sam_tiny_test,
    sam_vit_b,
)
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops import flash_attention as tfa
from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
from yolo_sam_inference_tpu_torch.parallel.launch import pick_backend, run_ranks
from yolo_sam_inference_tpu_torch.parallel.sp import rows_per_rank
from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.weights import load_tree, save_tree

torch.set_num_threads(1)

ENC_TOL = dict(rtol=2e-4, atol=2e-4)  # as tests/test_parallel.py holds JAX's sp encoder
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)  # fp32 on both sides; only the summation order differs
OPTS = dict(batch_size=4, max_det=8, metric_crop=48, yolo_size=64, nms_candidates=64,
            sam_encoder_size=64, compute_dtype=torch.float32)


def _tree(cfg, seed):
    """A vision tree with random rel-pos tables, pos embed, LN shifts and
    qkv biases (zeros would hide a wrong row offset)."""
    tree = {"vision": init_sam_params(seed, cfg)["vision"]}
    rng = np.random.default_rng(seed + 1)
    v = tree["vision"]
    v["pos_embed"] = (0.1 * rng.normal(size=v["pos_embed"].shape)).astype(np.float32)
    for lp in v["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = (0.3 * rng.normal(size=lp["attn"][key].shape)).astype(np.float32)
        lp["attn"]["qkv"]["b"] = (0.5 * rng.normal(size=lp["attn"]["qkv"]["b"].shape)
                                  ).astype(np.float32)
        lp["ln1"]["bias"] = (0.3 * rng.normal(size=lp["ln1"]["bias"].shape)).astype(np.float32)
    return tree


def _w14():
    return dataclasses.replace(sam_tiny_test(), image_size=224, window_size=14)  # grid 28


def _vit_b_cut():
    return dataclasses.replace(sam_vit_b(512), vision_layers=2, global_attn_indexes=(1,),
                               window_size=16)  # grid 32, window 16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 4 gloo ranks; every case's inputs and rank outputs."""
    d = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(7)
    cases = {
        "tiny": (sam_tiny_test(), _tree(sam_tiny_test(), 7),
                 rng.normal(size=(4, 64, 64, 3)).astype(np.float32)),
        "vit_b": (_vit_b_cut(), _tree(_vit_b_cut(), 3),
                  rng.normal(size=(1, 512, 512, 3)).astype(np.float32)),
        "w14": (_w14(), _tree(_w14(), 5), rng.normal(size=(2, 224, 224, 3)).astype(np.float32)),
    }
    jobs = []
    for name, (cfg, tree, pix) in cases.items():
        save_tree(d / f"{name}.npz", tree)
        np.save(d / f"{name}.npy", pix)
        for sp in ((2, 4) if name == "tiny" else (2,)):
            jobs.append({"kind": "encoder", "ranks": sp, "tree": str(d / f"{name}.npz"),
                         "cfg": cfg, "pix": str(d / f"{name}.npy"), "out": str(d / f"{name}{sp}")})
    frames = np.stack([make_cell_image(np.random.default_rng(22)) for _ in range(4)])
    np.save(d / "frames.npy", frames)
    kwargs = dict(device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
                  seed=0, options=tengine.PipelineOptions(encoder_parallel="sp", **OPTS))
    jobs.append({"kind": "pipeline", "ranks": 2, "kwargs": kwargs, "frames": str(d / "frames.npy"),
                 "out": str(d / "pipe")})
    backend = run_ranks(run_jobs, 4, (jobs,))
    return d, cases, frames, backend


def _rank_outputs(d, prefix, sp):
    return [np.load(d / f"{prefix}.rank{r}.npy") for r in range(sp)]


@pytest.mark.parametrize("name,sp", [("tiny", 2), ("tiny", 4), ("vit_b", 2), ("w14", 2)])
def test_sp_encoder_matches_jax_and_single_device(runs, name, sp):
    """Every rank returns the same embeddings, equal to JAX
    ``sam_image_encoder_sp`` on an sp-way CPU mesh, to JAX's single-device
    encoder and to the port's."""
    d, cases, _, backend = runs
    assert backend == "gloo"
    cfg, tree, pix = cases[name]
    outs = _rank_outputs(d, f"{name}{sp}", sp)
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    mesh = make_mesh_axes(devices=jax.devices()[:sp], sp=sp)
    want_sp = np.asarray(jax_sp(tree, jnp.asarray(pix), cfg, mesh))
    want = np.asarray(jsam.sam_image_encoder(tree, jnp.asarray(pix), cfg))
    with torch.inference_mode():
        single = SamImageEncoder(tree["vision"], cfg)(torch.from_numpy(pix)).numpy()
    assert outs[0].shape == want.shape
    np.testing.assert_allclose(outs[0], want_sp, **ENC_TOL)
    np.testing.assert_allclose(outs[0], want, **ENC_TOL)
    np.testing.assert_allclose(outs[0], single, **ENC_TOL)


def test_sp_engine_matches_single_device(runs):
    """``encoder_parallel="sp"`` over 2 ranks: each rank's outputs equal the
    single-device pipeline's (``test_parallel.py:409-441``)."""
    d, _, frames, _ = runs
    single = tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(**OPTS))
    want = single.process_batch_arrays(frames)
    assert want["valid"].sum() > 0
    for r in range(2):
        with np.load(d / f"pipe.rank{r}.npz") as got:
            for key in ("boxes", "scores", "valid", "offsets", "mask_crops"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
            for key in METRIC_KEYS:
                np.testing.assert_allclose(got[f"metric_{key}"], want["metrics"][key], rtol=1e-4,
                                           atol=1e-4, err_msg=key)


def test_sp_rejects_misaligned_shards():
    """As JAX ``sp.py:244-254`` (``test_parallel.py:313-323``)."""
    cfg = sam_tiny_test()  # grid 8, window 2
    assert rows_per_rank(cfg, 4) == 2
    with pytest.raises(ValueError, match="not a multiple of window_size"):
        rows_per_rank(cfg, 8)
    with pytest.raises(ValueError, match="must divide grid_size"):
        rows_per_rank(cfg, 3)
    only_global = dataclasses.replace(cfg, global_attn_indexes=(0, 1))
    assert rows_per_rank(only_global, 8) == 1  # no windowed layer: any divisor


def _pipe(process_group=None, **opts):
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(**{**OPTS, **opts}), process_group=process_group)


@pytest.mark.parametrize("opts,match", [
    (dict(encoder_parallel="tp"), "'tp' requires a torch.distributed process group"),
    (dict(encoder_parallel="sp"), "requires a torch.distributed process group"),
    (dict(encoder_parallel="sp", quant="int8"), "does not compose with quant='int8'"),
])
def test_encoder_parallel_validation(opts, match):
    """Clear errors, as the JAX engine's (``test_parallel.py:513-525``): no
    process group (sp and tp), int8 weights. int8 is refused by the encoder
    at the first batch, on a one-rank group."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    if opts.get("quant") != "int8":
        with pytest.raises(ValueError, match=match):
            _pipe(**opts)._stages(64, 64)
        return
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        pipe = _pipe(process_group=dist.group.WORLD, **opts)
        with pytest.raises(ValueError, match=match):
            pipe.process_batch_arrays(np.zeros((1, 64, 64, 3), np.uint8))
    finally:
        dist.destroy_process_group()


def test_encoder_parallel_refuses_tinyvit_and_unknown_modes():
    with pytest.raises(ValueError, match="ViT SAM encoders only"):
        tengine.CellSegmentationPipeline(
            sam_model_type="mobile-sam", device="cpu", sam_config=sam_tiny_test(),
            options=tengine.PipelineOptions(encoder_parallel="sp"),
        )._stages(64, 64)
    with pytest.raises(ValueError, match="encoder_parallel must be one of"):
        _pipe(encoder_parallel="pp")


def test_backend_choice_and_tree_files(tmp_path):
    """gloo when there are fewer cards than ranks (none here); a tree with
    lists and None leaves survives save_tree / load_tree."""
    assert pick_backend(2) == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    tree = {"a": [np.arange(3.0), {"b": np.ones((2, 2), np.float32)}], "none": None}
    save_tree(tmp_path / "t.npz", tree)
    back = load_tree(tmp_path / "t.npz")
    assert back["none"] is None and back["a"][1]["b"].dtype == np.float32
    np.testing.assert_array_equal(back["a"][0], tree["a"][0])


@pytest.mark.parametrize("s,hd,sp,rank", [(8, 64, 2, 1), (14, 80, 2, 1), (8, 80, 4, 2)])
def test_relpos_entry_on_a_rank_share_matches_jax_kernel(s, hd, sp, rank):
    """K12 on rank ``rank`` of ``sp``: its own q rows (a view of its qkv,
    row0 = rank * S / sp > 0) over the gathered k | v of every rank (views
    with a token stride of 2C)."""
    rng = np.random.default_rng(10 * s + hd + rank)
    b, heads = 2, 2
    c, hl = heads * hd, s // sp
    qkv = [rng.normal(size=(b, hl * s, 3 * c)).astype(np.float32) for _ in range(sp)]
    rel_h, rel_w = (0.5 * rng.normal(size=(2 * s - 1, hd)).astype(np.float32) for _ in range(2))
    kv = np.concatenate([part[..., c:] for part in qkv], axis=1)  # rank order is row order
    own, kvt = torch.from_numpy(qkv[rank]), torch.from_numpy(kv)
    got = tfa.flash_attention_relpos(own[..., :c], kvt[..., :c], kvt[..., c:],
                                     torch.from_numpy(rel_h), torch.from_numpy(rel_w), s,
                                     row0=rank * hl)
    want = jax_relpos_attention(qkv[rank][..., :c], kv[..., :c], kv[..., c:], rel_h, rel_w, s,
                                rank * hl, heads)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
