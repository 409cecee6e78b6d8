"""The port's tensor-parallel encoder and engine against the JAX package, on
the CPU.

One launch of four gloo ranks (``parallel.launch.run_ranks``, the rank
functions of ``parallel.workers``: they import neither jax nor this file)
runs every multi-rank case:

* the tiny SAM config (2 heads, MLP 64) at tp = 2 (ranks 0-1) and on a
  dp 2 x tp 2 mesh (all four: each dp member's share of the batch, its tp
  pair running the encoder);
* SAM ViT-B widths (C 768, 12 heads: 6 a rank) at grid 32, window 16, cut to
  2 layers, at tp = 2;
* the tiny config at grid 28 and SAM's window of 14 (the flat route: K12 and
  the residual LayerNorms; zero-padded partitions) at tp = 2;
* ``PipelineOptions(encoder_parallel="tp")`` on the tiny pipeline over 2
  ranks and on a dp 2 x tp 2 mesh.

The parent holds the ranks' results against JAX ``sam_image_encoder_tp`` on
the virtual CPU mesh (``tests/test_parallel.py:235-268``), JAX's and the
port's single-device encoders, and the port's single-device pipeline
(``test_parallel.py:376-405``). fp32 throughout. The trees carry random
biases, LayerNorm shifts, rel-pos tables and positional embedding: a bias
added on every rank before the all-reduce, or a wrong head slice, shows.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from synth import make_cell_image
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolo_sam_inference_tpu.parallel.tp import sam_image_encoder_tp as jax_tp
from yolo_sam_inference_tpu.parallel.tp import shard_sam_encoder_tp as jax_shard
from yolo_sam_inference_tpu_torch.models.sam import (
    SamImageEncoder,
    init_sam_params,
    sam_tiny_test,
    sam_vit_b,
)
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
from yolo_sam_inference_tpu_torch.parallel import tp as ttp
from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
from yolo_sam_inference_tpu_torch.weights import save_tree

torch.set_num_threads(1)

ENC_TOL = dict(rtol=2e-4, atol=2e-4)  # as tests/test_parallel.py:268 holds JAX's tp encoder
OPTS = dict(batch_size=4, max_det=8, metric_crop=48, yolo_size=64, nms_candidates=64,
            sam_encoder_size=64, compute_dtype=torch.float32)


def _tree(cfg, seed):
    """A vision tree with every bias, LN shift, rel-pos table and the
    positional embedding drawn at random (zeros would hide a bias added
    before the all-reduce)."""
    tree = {"vision": init_sam_params(seed, cfg)["vision"]}
    rng = np.random.default_rng(seed + 1)
    v = tree["vision"]

    def draw(a, scale):
        return (scale * rng.normal(size=a.shape)).astype(np.float32)

    v["pos_embed"] = draw(v["pos_embed"], 0.1)
    for lp in v["layers"]:
        a = lp["attn"]
        for key in ("rel_pos_h", "rel_pos_w"):
            a[key] = draw(a[key], 0.3)
        for rec in (a["qkv"], a["proj"], lp["mlp1"], lp["mlp2"]):
            rec["b"] = draw(rec["b"], 0.3)
        for ln in (lp["ln1"], lp["ln2"]):
            ln["bias"] = draw(ln["bias"], 0.3)
    return tree


def _w14():
    return dataclasses.replace(sam_tiny_test(), image_size=224, window_size=14)  # grid 28


def _vit_b_cut():
    return dataclasses.replace(sam_vit_b(512), vision_layers=2, global_attn_indexes=(1,),
                               window_size=16)  # grid 32, window 16


# name -> (config, tree seed, pixel shape, tp, dp)
CASES = {
    "tiny2": (sam_tiny_test, 7, (4, 64, 64, 3), 2, 1),
    "tiny_dp2tp2": (sam_tiny_test, 7, (4, 64, 64, 3), 2, 2),
    "vit_b2": (_vit_b_cut, 3, (1, 512, 512, 3), 2, 1),
    "w14_2": (_w14, 5, (2, 224, 224, 3), 2, 1),
}


def _pipe_kwargs(**opts):
    return dict(device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1),
                seed=0, options=tengine.PipelineOptions(**{**OPTS, **opts}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 4 gloo ranks; every case's inputs and rank outputs."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(11)
    cases, jobs = {}, []
    for name, (cfg_fn, seed, shape, tp, dp) in CASES.items():
        cfg = cfg_fn()
        tree, pix = _tree(cfg, seed), rng.normal(size=shape).astype(np.float32)
        cases[name] = (cfg, tree, pix, tp, dp)
        save_tree(d / f"{name}.npz", tree)
        np.save(d / f"{name}.npy", pix)
        job = {"kind": "encoder", "parallel": "tp", "tree": str(d / f"{name}.npz"), "cfg": cfg,
               "pix": str(d / f"{name}.npy"), "out": str(d / name)}
        if dp > 1:
            job["mesh"] = {"dp": dp, "tp": tp}
        else:
            job["ranks"] = tp
        jobs.append(job)
    frames = np.stack([make_cell_image(np.random.default_rng(31)) for _ in range(4)])
    np.save(d / "frames.npy", frames)
    kwargs = _pipe_kwargs(encoder_parallel="tp")
    jobs.append({"kind": "pipeline", "ranks": 2, "kwargs": kwargs, "frames": str(d / "frames.npy"),
                 "out": str(d / "pipe")})
    jobs.append({"kind": "dp", "mesh": {"dp": 2, "tp": 2}, "kwargs": kwargs,
                 "frames": [str(d / "frames.npy")], "out": str(d / "dptp")})
    backend = run_ranks(run_jobs, 4, (jobs,))
    single = tengine.CellSegmentationPipeline(**_pipe_kwargs())
    return {"d": d, "cases": cases, "frames": frames, "backend": backend,
            "want": single.process_batch_arrays(frames)}


def _ranks_of(tp: int, dp: int):
    """Global ranks by (dp index, tp index): the mesh lays tp on consecutive
    ranks."""
    return np.arange(dp * tp).reshape(dp, tp)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_encoder_matches_jax_and_single_device(runs, name):
    """Every rank of a tp group returns the same embeddings of its dp share,
    equal to JAX ``sam_image_encoder_tp`` on a (dp, tp) CPU mesh, to JAX's
    single-device encoder and to the port's."""
    assert runs["backend"] == "gloo"
    d = runs["d"]
    cfg, tree, pix, tp, dp = runs["cases"][name]
    grid = _ranks_of(tp, dp)
    outs = [[np.load(d / f"{name}.rank{r}.npy") for r in row] for row in grid]
    for row in outs:
        for o in row[1:]:
            np.testing.assert_array_equal(o, row[0])
    got = np.concatenate([row[0] for row in outs])
    mesh = jax_make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    tp_params, tp_specs = jax_shard(tree, cfg, mesh)
    want_tp = np.asarray(jax_tp(tp_params, tp_specs, jnp.asarray(pix), cfg, mesh))
    want = np.asarray(jsam.sam_image_encoder(tree, jnp.asarray(pix), cfg))
    with torch.inference_mode():
        single = SamImageEncoder(tree["vision"], cfg)(torch.from_numpy(pix)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want_tp, **ENC_TOL)
    np.testing.assert_allclose(got, want, **ENC_TOL)
    np.testing.assert_allclose(got, single, **ENC_TOL)


@pytest.mark.parametrize("name", ["tiny2", "vit_b2"])
def test_each_rank_keeps_only_its_shard(runs, name):
    """qkv ``(C, 3 hl hd)``, proj ``(hl hd, C)``, mlp1 ``(C, H / tp)``, mlp2
    ``(H / tp, C)`` on every rank (JAX's addressable shards, ``test_parallel.py:
    256-260``)."""
    cfg, _, _, tp, _ = runs["cases"][name]
    c, hid = cfg.vision_hidden, cfg.vision_mlp_dim // tp
    for r in range(tp):
        with open(runs["d"] / f"{name}.rank{r}.json") as f:
            shapes = json.load(f)
        assert shapes == {"layers": cfg.vision_layers, "qkv": [c, 3 * c // tp],
                          "proj": [c // tp, c], "mlp1": [c, hid], "mlp2": [hid, c]}


def test_shard_layout_against_jax():
    """Rank r's qkv columns are JAX's ``(C, 3, heads, hd)`` shard r, flattened;
    its proj rows and MLP slices JAX's too; :func:`unshard_layers` inverts
    the cut."""
    cfg = sam_tiny_test()
    tree = _tree(cfg, 3)
    mesh = jax_make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    jp, _ = jax_shard(tree, cfg, mesh)
    for i, lp in enumerate(tree["vision"]["layers"]):
        shards = [ttp.shard_layer(lp, cfg, 2, r) for r in range(2)]
        jl = jp["layers"][i]
        qkv_w, proj_w = np.asarray(jl["attn"]["qkv_w"]), np.asarray(jl["attn"]["proj_w"])
        for r, s in enumerate(shards):  # 1 head a rank
            np.testing.assert_array_equal(s["attn"]["qkv"]["w"],
                                          qkv_w[:, :, r:r + 1].reshape(32, -1))
            np.testing.assert_array_equal(s["attn"]["proj"]["w"],
                                          proj_w[r:r + 1].reshape(-1, 32))
            np.testing.assert_array_equal(s["mlp1"]["w"], np.asarray(jl["mlp1"]["w"])[:, 32 * r:
                                                                                   32 * r + 32])
        back = ttp.unshard_layers(shards, cfg)
        for key in ("qkv", "proj"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(back["attn"][key][leaf], lp["attn"][key][leaf])
        for key in ("mlp1", "mlp2"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(back[key][leaf], lp[key][leaf])


def test_tp_requires_divisible_heads():
    """As JAX ``tp.py:72-75`` (``test_parallel.py:271-279``): tp = 4 on 2 heads."""
    cfg = sam_tiny_test()
    tree = init_sam_params(0, cfg)
    with pytest.raises(ValueError, match="tp=4 must divide heads=2"):
        ttp.shard_sam_encoder_tp(tree, cfg, 4, 0)
    with pytest.raises(ValueError, match="tp=4 must divide heads=2"):
        jax_shard(tree, cfg, jax_make_mesh(dp=2, tp=4))


def _close(got, want):
    for key in ("boxes", "scores", "valid", "offsets", "mask_crops"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4, err_msg=key)
    for key in METRIC_KEYS:
        np.testing.assert_allclose(got[f"metric_{key}"], want["metrics"][key], rtol=1e-4,
                                   atol=1e-4, err_msg=key)


def test_tp_engine_matches_single_device(runs):
    """``encoder_parallel="tp"`` over 2 ranks: each rank's outputs equal the
    single-device pipeline's (``test_parallel.py:376-405``)."""
    assert runs["want"]["valid"].sum() > 0
    for r in range(2):
        with np.load(runs["d"] / f"pipe.rank{r}.npz") as got:
            _close(got, runs["want"])


def test_dp_tp_engine_matches_single_device(runs):
    """The engine on a dp 2 x tp 2 mesh: each dp member runs its 2 frames with
    its tp pair; every rank returns the whole batch's outputs, the single
    device's."""
    for r in range(4):
        with np.load(runs["d"] / f"dptp.rank{r}.npz") as z:
            _close({k[2:]: z[k] for k in z.files}, runs["want"])


def test_tp_engine_reshards_new_params():
    """A caller's new parameter tree is sharded anew, not the old shard run
    stale (JAX ADVICE r4, ``test_parallel.py:485-510``), on a one-rank tp
    group in this process."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        pipe = tengine.CellSegmentationPipeline(**_pipe_kwargs(encoder_parallel="tp"),
                                                process_group=dist.group.WORLD)
        frames = np.stack([make_cell_image(np.random.default_rng(24)) for _ in range(2)])
        img = torch.from_numpy(frames)
        with torch.inference_mode():
            base = pipe._stages(64, 64)["embed"](img).numpy()
            kept = pipe.sam_params
            pipe.sam_params = {k: v for k, v in kept.items()}
            pipe.sam_params["vision"] = jax.tree_util.tree_map(lambda a: a * 0, kept["vision"])
            zeroed = pipe._stages(64, 64)["embed"](img).numpy()
            pipe.sam_params = kept
            again = pipe._stages(64, 64)["embed"](img).numpy()
    finally:
        dist.destroy_process_group()
    assert not np.allclose(zeroed, base)
    np.testing.assert_allclose(again, base, rtol=1e-6, atol=1e-6)


def test_tp_refuses_int8():
    """int8 weights do not shard (JAX ``engine.py:800-805``)."""
    from yolo_sam_inference_tpu_torch.ops.quant import quantize_sam_encoder_params

    cfg = sam_tiny_test()
    tree = quantize_sam_encoder_params(init_sam_params(0, cfg))
    with pytest.raises(ValueError, match="does not compose with quant='int8'"):
        ttp.shard_sam_encoder_tp(tree, cfg, 2, 0)
