"""The port's pipeline-parallel encoder and its multi-rank dry run against
the JAX package, on the CPU.

One launch of four gloo ranks (``parallel.launch.run_ranks``, the rank
functions of ``parallel.workers``: they import neither jax nor this file)
runs every multi-rank case:

* the tiny SAM config (2 layers) at pp = 2 (ranks 0-1) with 4 and with 2
  microbatches (``tests/test_parallel.py:326-349``);
* the tiny config deepened to 4 layers (globals 1 and 3) at pp = 4 and pp = 2
  (two layers a stage: a stage's first layer is not the model's first);
* the tiny config at grid 28 and SAM's window of 14 (the flat route: a stage
  hands on ``x + pending``, the MLP residual the single-card route carries
  into the next LayerNorm) at pp = 2;
* SAM ViT-B widths at grid 32, window 16, cut to 2 layers, at pp = 2;
* ``parallel.dryrun``'s five parts on the four ranks (the port's
  ``dryrun_multichip(4, device="cpu")``, the JAX ``__graft_entry__.py:52``).

The parent holds the ranks' embeddings against JAX ``sam_image_encoder_pp``
on the virtual CPU mesh, JAX's and the port's single-device encoders. fp32.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_tp import _tree
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu.parallel.mesh import make_mesh_axes as jax_mesh_axes
from yolo_sam_inference_tpu.parallel.pp import sam_image_encoder_pp as jax_pp
from yolo_sam_inference_tpu_torch.models.sam import SamImageEncoder, sam_tiny_test, sam_vit_b
from yolo_sam_inference_tpu_torch.parallel import pp as tpp
from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
from yolo_sam_inference_tpu_torch.weights import save_tree

torch.set_num_threads(1)

ENC_TOL = dict(rtol=2e-4, atol=2e-4)  # as tests/test_parallel.py:344 holds JAX's pp encoder


def _deep():
    return dataclasses.replace(sam_tiny_test(), vision_layers=4, global_attn_indexes=(1, 3))


def _w14():
    return dataclasses.replace(sam_tiny_test(), image_size=224, window_size=14)  # grid 28


def _vit_b_cut():
    return dataclasses.replace(sam_vit_b(512), vision_layers=2, global_attn_indexes=(1,),
                               window_size=16)


# name -> (config, tree seed, pixel shape, pp, microbatches)
CASES = {
    "tiny_pp2_m4": (sam_tiny_test, 9, (4, 64, 64, 3), 2, 4),
    "tiny_pp2_m2": (sam_tiny_test, 9, (4, 64, 64, 3), 2, 2),
    "deep_pp4": (_deep, 4, (4, 64, 64, 3), 4, None),
    "deep_pp2": (_deep, 4, (4, 64, 64, 3), 2, 4),
    "w14_pp2": (_w14, 5, (2, 224, 224, 3), 2, 2),
    "vit_b_pp2": (_vit_b_cut, 3, (2, 512, 512, 3), 2, 2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 4 gloo ranks; every case's inputs and rank outputs."""
    d = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(13)
    cases, jobs = {}, []
    for name, (cfg_fn, seed, shape, pp, m) in CASES.items():
        cfg = cfg_fn()
        tree, pix = _tree(cfg, seed), rng.normal(size=shape).astype(np.float32)
        cases[name] = (cfg, tree, pix, pp, m)
        save_tree(d / f"{name}.npz", tree)
        np.save(d / f"{name}.npy", pix)
        jobs.append({"kind": "encoder", "parallel": "pp", "ranks": pp, "microbatches": m,
                     "tree": str(d / f"{name}.npz"), "cfg": cfg, "pix": str(d / f"{name}.npy"),
                     "out": str(d / name)})
    jobs.append({"kind": "dryrun", "device": "cpu", "out": str(d / "dryrun")})
    backend = run_ranks(run_jobs, 4, (jobs,))
    return {"d": d, "cases": cases, "backend": backend}


@pytest.mark.parametrize("name", list(CASES))
def test_pp_encoder_matches_jax_and_single_device(runs, name):
    """Every stage returns the same embeddings, equal to JAX
    ``sam_image_encoder_pp`` on a pp-way CPU mesh, to JAX's single-device
    encoder and to the port's; each stage held only its layers."""
    assert runs["backend"] == "gloo"
    d = runs["d"]
    cfg, tree, pix, pp, m = runs["cases"][name]
    outs = [np.load(d / f"{name}.rank{r}.npy") for r in range(pp)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    for r in range(pp):
        with open(d / f"{name}.rank{r}.json") as f:
            assert json.load(f)["layers"] == cfg.vision_layers // pp
    mesh = jax_mesh_axes(devices=jax.devices()[:pp], pp=pp)
    want_pp = np.asarray(jax_pp(tree, jnp.asarray(pix), cfg, mesh, microbatches=m))
    want = np.asarray(jsam.sam_image_encoder(tree, jnp.asarray(pix), cfg))
    with torch.inference_mode():
        single = SamImageEncoder(tree["vision"], cfg)(torch.from_numpy(pix)).numpy()
    assert outs[0].shape == want.shape
    np.testing.assert_allclose(outs[0], want_pp, **ENC_TOL)
    np.testing.assert_allclose(outs[0], want, **ENC_TOL)
    np.testing.assert_allclose(outs[0], single, **ENC_TOL)


def test_pp_rejects_bad_partitions():
    """As JAX ``pp.py:137-143`` (``test_parallel.py:352-370``): pp = 3 on 2
    layers, 3 microbatches of a batch of 4."""
    cfg = sam_tiny_test()
    with pytest.raises(ValueError, match="pp=3 must divide vision_layers=2"):
        tpp.stage_range(cfg, 3, 0)
    assert list(tpp.stage_range(_deep(), 2, 1)) == [2, 3]
    tree = _tree(cfg, 0)
    pix = jnp.zeros((4, 64, 64, 3), jnp.float32)
    with pytest.raises(ValueError, match="must divide vision_layers"):
        jax_pp(tree, pix, cfg, jax_mesh_axes(devices=jax.devices()[:3], pp=3))
    with pytest.raises(ValueError, match="microbatches=3 must divide batch=4"):
        jax_pp(tree, pix, cfg, jax_mesh_axes(devices=jax.devices()[:2], pp=2), microbatches=3)


def test_pp_rejects_microbatches_on_one_rank_group():
    """The batch check on a one-rank group in this process (a stage of one):
    ``microbatches=3`` of 4 raises, as JAX; a stage built from the wrong
    tree raises."""
    import torch.distributed as dist

    cfg = sam_tiny_test()
    tree = _tree(cfg, 0)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        enc = SamImageEncoder(tpp.stage_tree(tree, cfg, 1, 0)["vision"], cfg)
        pix = torch.zeros((4, 64, 64, 3))
        with pytest.raises(ValueError, match="microbatches=3 must divide batch=4"):
            tpp.sam_image_encoder_pp(enc, pix, cfg, microbatches=3)
        got = tpp.sam_image_encoder_pp(enc, pix, cfg)
        with torch.inference_mode():
            np.testing.assert_array_equal(got.detach().numpy(), enc(pix).numpy())
        short = SamImageEncoder(tpp.stage_tree(tree, cfg, 2, 0)["vision"], cfg)
        with pytest.raises(ValueError, match="holds 1 layers, expected 2"):
            tpp.sam_image_encoder_pp(short, pix, cfg)
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_on_four_ranks(runs):
    """The port's ``dryrun_multichip`` parts on the four CPU ranks: the dp
    engine, the tp encoder and the dp x tp engine, the sp encoder and the
    dp x sp engine, the pp encoder, two dp x tp train steps with a falling
    loss (``__graft_entry__.py:52``)."""
    for r in range(4):
        with open(runs["d"] / f"dryrun.rank{r}.json") as f:
            info = json.load(f)
        parts = {"dp engine", "tp encoder", "dp x tp engine", "sp encoder", "dp x sp engine",
                 "train"} | ({"pp encoder"} if r < 2 else set())
        assert set(info["parts"]) == parts
        loss1, loss2 = info["losses"]
        assert np.isfinite(loss1) and loss2 < loss1
