"""The port's SAM fine-tune step, the gradients through its kernels and its
parameter checkpoints, against the JAX package, on the CPU.

* ``parallel/train.py`` on one rank against JAX ``make_train_state`` /
  ``sam_decoder_train_step`` on a one-device mesh: the tiny config in fp32,
  two steps on one batch (4 frames x 3 boxes, some not valid), computed once
  for the module (two JAX steps take about 21 s here).
* One launch of four gloo ranks (``parallel.launch.run_ranks``, the
  ``"train"`` job of ``parallel.workers``) runs the step on a dp 2 x tp 2
  mesh (on the grid route, and on the flat route at a window of 3) and on
  dp 4; their losses, gathered parameters and step 1's gathered gradients
  are held against the single rank, and the parameters replicated over tp
  must stay equal on the tp ranks.
* ``ops/autograd.py``: ``torch.autograd.gradcheck`` of its Function in
  float64, and its gradients through each wrapped kernel's plain version
  against autograd of that plain version; the refusal; the kernel-form cache
  (``ops.fused_ln._derived``) remade after an in-place update.
* ``utils/checkpoint.py``: a file written by either package loads in the
  other; a tp-trained state gathered to one tree loads into the JAX tree.

Tolerances: step 1's gradients on a mesh within 1e-4 of the tensor's largest
element of the single rank's, the key biases' (true gradient zero) within
1e-7 (the sums over ranks change only the order of fp32 additions; AdamW's step hardly depends on a gradient's scale, so a
gradient summed where it should be averaged shows here, not in the
parameters); losses rtol 1e-4; parameters rtol 1e-5 / atol 1e-5 (a tenth of
one step of the learning rate, 1e-4: a gradient lost or counted twice moves
a weight by a whole step), but the attention key biases atol 2e-4, twice the
learning rate: their true gradient is zero (softmax drops a shift of a
query's logits), so each package's is rounding noise, which Adam's
normalised step turns into a full step of either sign.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

from yolo_sam_inference_tpu.models.sam import sam_tiny_test as jax_tiny
from yolo_sam_inference_tpu.parallel import train as jtrain
from yolo_sam_inference_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolo_sam_inference_tpu.utils import checkpoint as jckpt
from yolo_sam_inference_tpu_torch.models.sam import (
    SamModel,
    init_sam_params,
    init_tinyvit_params,
    sam_tiny_test,
)
from yolo_sam_inference_tpu_torch.models.sam.tinyvit import TinyViTConfig
from yolo_sam_inference_tpu_torch.ops import autograd as tag
from yolo_sam_inference_tpu_torch.ops import decoder_fused as tdec
from yolo_sam_inference_tpu_torch.ops import flash_attention as tfa
from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
from yolo_sam_inference_tpu_torch.ops.quant import quantize_sam_encoder_params
from yolo_sam_inference_tpu_torch.parallel import train as ttrain
from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
from yolo_sam_inference_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

SEED, STEPS, LR = 3, 2, 1e-4
LOSS_RTOL, PARAM_ATOL = 1e-4, 2 * LR


def _flat_cfg():
    """The tiny config on the flat route: a window of 3 does not divide the
    grid of 8 (zero-padded partitions, K11d's residual LayerNorms)."""
    return dataclasses.replace(sam_tiny_test(), window_size=3)


CFGS = {"grid": sam_tiny_test, "flat": _flat_cfg}


def _batch():
    cfg = sam_tiny_test()
    rng = np.random.default_rng(5)
    low = cfg.low_res_size
    valid = np.ones((4, 3), np.float32)
    valid[0, 2] = valid[3, :2] = 0.0  # the dp shares' valid counts differ
    return {"images": rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
            "boxes": rng.uniform(0, 64, size=(4, 3, 4)).astype(np.float32),
            "masks": (rng.random((4, 3, low, low)) > 0.5).astype(np.float32),
            "valid": valid}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's two steps on a one-device mesh: losses and the flat parameters."""
    mesh = jax_make_mesh(dp=1, tp=1, devices=jax.devices()[:1])
    state = jtrain.make_train_state(SEED, jax_tiny(), mesh, learning_rate=LR)
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    losses = []
    for _ in range(STEPS):
        state, loss = jtrain.sam_decoder_train_step(state, batch, jax_tiny(), mesh)
        losses.append(float(loss))
    params = jax.tree_util.tree_map(np.asarray, state["params"])
    return {"losses": losses, "flat": tckpt.flatten_tree(params), "tree": params}


def _single_run(cfg):
    """The port's two steps on one rank, in this process, and step 1's
    gradients."""
    state = ttrain.make_train_state(SEED, cfg, device="cpu", learning_rate=LR)
    losses = []
    for step in range(STEPS):
        state, loss = ttrain.sam_decoder_train_step(state, _batch(), cfg)
        losses.append(loss)
        if step == 0:
            grads1 = {k: p.grad.detach().numpy().copy() for k, p in state["params"].items()}
    return {"losses": losses, "state": state, "grads1": grads1,
            "flat": {k: p.detach().numpy() for k, p in state["params"].items()}}


@pytest.fixture(scope="module")
def single():
    return _single_run(sam_tiny_test())


@pytest.fixture(scope="module")
def single_flat():
    return _single_run(_flat_cfg())


# name: (mesh, route of the config)
MESHES = {"dp2tp2": ({"dp": 2, "tp": 2}, "grid"), "dp4": ({"dp": 4}, "grid"),
          "dp2tp2_flat": ({"dp": 2, "tp": 2}, "flat")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch of 4 gloo ranks: the step on each mesh of ``MESHES``."""
    d = tmp_path_factory.mktemp("train")
    np.savez(d / "batch.npz", **_batch())
    jobs = [{"kind": "train", "cfg": CFGS[route](), "seed": SEED, "steps": STEPS, "mesh": mesh,
             "batch": str(d / "batch.npz"), "out": str(d / name)}
            for name, (mesh, route) in MESHES.items()]
    backend = run_ranks(run_jobs, 4, (jobs,))
    return d, backend


def _key_bias(key: str, w: np.ndarray) -> np.ndarray:
    """The elements of a leaf whose true gradient is zero: attention key
    biases (a shift of every logit of a query, which the softmax drops)."""
    mask = np.zeros(w.shape, bool)
    if key.endswith("::k::b"):
        mask[:] = True
    elif key.endswith("attn::qkv::b"):
        mask[w.size // 3:2 * w.size // 3] = True
    return mask


def _params_close(got: dict, want: dict) -> None:
    """Every element within rtol 1e-5 / atol 1e-5 (a tenth of one step), the
    key biases' within ``PARAM_ATOL``."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        kb = _key_bias(key, w)
        np.testing.assert_allclose(g[kb], w[kb], rtol=0, atol=PARAM_ATOL, err_msg=key)
        np.testing.assert_allclose(g[~kb], w[~kb], rtol=1e-5, atol=1e-5, err_msg=key)


def test_train_step_matches_jax(jax_run, single):
    """Two fp32 steps: the losses within rtol 1e-4 and every parameter within
    the module's atol of JAX's (``parallel/train.py:63-133``)."""
    np.testing.assert_allclose(single["losses"], jax_run["losses"], rtol=LOSS_RTOL)
    assert single["losses"][1] < single["losses"][0]
    _params_close(single["flat"], jax_run["flat"])
    assert single["state"]["step"] == STEPS


def test_unreached_leaves_decay_as_optax():
    """Leaves the loss does not reach (the point prompt's ``not_a_point``, the
    hypernetworks of masks 1-3) get a zero gradient, not none, so AdamW still
    decays them by ``1 - lr * 1e-4`` a step, as optax's adamw does (torch's
    skips a parameter without a gradient). At lr 0.1, where one step's decay
    shows in fp32."""
    cfg, lr = sam_tiny_test(), 0.1
    init = tckpt.flatten_tree(init_sam_params(SEED, cfg))
    state = ttrain.make_train_state(SEED, cfg, device="cpu", learning_rate=lr)
    state, _ = ttrain.sam_decoder_train_step(state, _batch(), cfg)
    for key in ("prompt::not_a_point", "decoder::hyper_mlps::2::in::w"):
        got = state["params"][key].detach().numpy()
        np.testing.assert_allclose(got, init[key] * np.float32(1 - lr * 1e-4), rtol=1e-6)
        assert not np.array_equal(got, init[key])
    assert state["opt_state"].defaults["weight_decay"] == 1e-4


@pytest.mark.parametrize("name", list(MESHES))
def test_train_on_meshes_matches_single_rank(runs, single, single_flat, name):
    """dp 2 x tp 2 (grid and flat routes) and dp 4: the loss is the whole
    batch's (divided by the global valid count), the gathered parameters the
    single rank's."""
    d, backend = runs
    ref = single_flat if MESHES[name][1] == "flat" else single
    assert backend == "gloo"
    for r in range(4):
        with open(d / f"{name}.rank{r}.json") as f:
            np.testing.assert_allclose(json.load(f)["losses"], ref["losses"], rtol=1e-5)
    with np.load(d / f"{name}.whole.npz") as z:
        _params_close(dict(z), ref["flat"])


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_step1_gradients_match_single_rank(runs, single, single_flat, name):
    """Step 1's gradients reduced over the mesh and gathered to one tree
    equal the single rank's, tensor for tensor: a replicated leaf that each
    tp rank applies to its own heads or columns alone (the rel-pos tables;
    on the grid route the LayerNorms fused behind Megatron's f) is summed
    over tp, every other replicated one averaged, a split one gathered."""
    d, _ = runs
    ref = single_flat if MESHES[name][1] == "flat" else single
    with np.load(d / f"{name}.grads1.npz") as z:
        got = dict(z)
    assert set(got) == set(ref["grads1"])
    for key, w in ref["grads1"].items():
        g, kb = got[key], _key_bias(key, w)
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g[~kb], w[~kb], rtol=0,
                                   atol=1e-4 * np.abs(w[~kb]).max(initial=0.0), err_msg=key)
        np.testing.assert_allclose(g[kb], w[kb], rtol=0, atol=1e-7, err_msg=key)  # zero, noise


def test_tp_partial_gradient_leaves():
    """The leaves whose gradient a tp rank holds a share of: the rel-pos
    tables on both routes, the layer LayerNorms on the grid route only."""
    for route, extra in (("grid", {"ln1::scale", "ln1::bias", "ln2::scale", "ln2::bias"}),
                         ("flat", set())):
        cfg = CFGS[route]()
        state = ttrain.make_train_state(SEED, cfg, device="cpu")
        assert state["_model"].vision.grid_route() == (route == "grid")
        kinds = {k: ttrain.tp_kind(state, k) for k in state["params"]}
        partial = {k.split("::", 3)[3] for k, v in kinds.items() if v == "partial"}
        assert partial == {"attn::rel_pos_h", "attn::rel_pos_w"} | extra
        assert sum(v == "sharded" for v in kinds.values()) == 6 * cfg.vision_layers
        assert kinds["vision::layers::0::attn::proj::b"] == kinds["decoder::ln_final::scale"] \
            == "whole"


def test_tp_replicated_parameters_stay_equal(runs):
    """On dp 2 x tp 2 (ranks (0, 1) and (2, 3) are tp pairs): every
    parameter that tp does not split is bit-equal on all four ranks after
    the steps; each split one is equal on the two ranks of a dp pair and
    holds its shard's shape."""
    d, _ = runs
    ranks = [dict(np.load(d / f"dp2tp2.rank{r}.npz")) for r in range(4)]
    sharded = [k for k in ranks[0] if k.startswith("vision::layers::")
               and k.endswith(ttrain.TP_SHARDED)]
    assert len(sharded) == 6 * sam_tiny_test().vision_layers
    for key in ranks[0]:
        if key in sharded:
            for a, b in ((0, 2), (1, 3)):
                np.testing.assert_array_equal(ranks[a][key], ranks[b][key], err_msg=key)
            assert not np.array_equal(ranks[0][key], ranks[1][key])
        else:
            for r in (1, 2, 3):
                np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=key)
    assert ranks[0]["vision::layers::0::attn::qkv::w"].shape == (32, 48)


def test_tp_trained_tree_loads_into_jax(runs, jax_run):
    """The dp 2 x tp 2 state, gathered to one tree and written by rank 0,
    loads into the JAX tree's structure through the JAX module."""
    d, _ = runs
    back = jckpt.load_params_npz(d / "dp2tp2.whole.npz", jax_run["tree"])
    flat = tckpt.flatten_tree(back)
    assert set(flat) == set(jax_run["flat"])
    _params_close(flat, jax_run["flat"])


def test_module_names_cover_the_model():
    """Every ``SamModel`` parameter has exactly one tree leaf, and the model
    holds every leaf (the point prompt's not-a-point embedding too)."""
    tree = init_sam_params(0, sam_tiny_test())
    model = SamModel(tree, sam_tiny_test())
    names = {k: ttrain.module_name(k) for k in tckpt.flatten_tree(tree)}
    held = [n for n in names.values() if n is not None]
    assert sorted(held) == sorted(n for n, _ in model.named_parameters())
    assert [k for k, n in names.items() if n is None] == []
    assert names["prompt::not_a_point"] == "prompt.not_a_point"
    with pytest.raises(ValueError, match="no SamModel parameter"):
        ttrain.module_name("vision::bogus")


def test_train_refuses_what_jax_cannot_train():
    """int8 weights, TinyViT and a missing card raise."""
    cfg = sam_tiny_test()
    tree = init_sam_params(0, cfg)
    with pytest.raises(ValueError, match="float weights"):
        ttrain.make_train_state(0, cfg, params=quantize_sam_encoder_params(tree), device="cpu")
    mobile = {**tree, "tinyvit": init_tinyvit_params(1, TinyViTConfig(image_size=64))}
    mobile.pop("vision")
    with pytest.raises(ValueError, match="ViT encoders only"):
        ttrain.make_train_state(0, cfg, params=mobile, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.make_train_state(0, cfg)


def test_loss_terms_are_jax_loss():
    """The per-box loss against the JAX formula on the same logits
    (``train.py:87-96``): optax's sigmoid BCE, the detached IoU, valid."""
    import optax

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    iou = rng.random((2, 3)).astype(np.float32)
    masks = (rng.random((2, 3, 8, 8)) > 0.5).astype(np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    total, count = ttrain.loss_terms(torch.from_numpy(logits), torch.from_numpy(iou),
                                     torch.from_numpy(masks), torch.from_numpy(valid))
    bce = np.asarray(optax.sigmoid_binary_cross_entropy(logits, masks)).mean(axis=(-2, -1))
    pred = (logits > 0).astype(np.float32)
    actual = (pred * masks).sum((-2, -1)) / np.maximum(
        (pred + masks - pred * masks).sum((-2, -1)), 1.0)
    want = ((bce + 0.1 * (iou - actual) ** 2) * valid).sum()
    assert float(count) == valid.sum()
    np.testing.assert_allclose(float(total), want, rtol=1e-6)


# ---------------------------------------------------------------- ops/autograd.py


def _ln_matmul64(x, w, b, ln, scale_out=None, *, shift=0.0):
    """A float64-faithful stand-in for a kernel: LN, product, a tuple out."""
    y = F.layer_norm(x, (x.shape[-1],), ln[0], ln[1], ln[2]) @ w + b + shift
    if scale_out is not None:
        y = y * scale_out
    return y, y.sum(-1)


def test_through_kernel_gradcheck_float64():
    """``gradcheck`` of the Function: tensors inside a tuple, a None, a
    keyword, a tuple out; the backward keeps float64 (fp32 or wider)."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64, requires_grad=True)

    x, w, b, s, sh = r(3, 5), r(5, 4), r(4), r(5), r(5)

    def fn(x, w, b, s, sh):
        return tag.through_kernel(_ln_matmul64, _ln_matmul64, x, w, b, (s, sh, 1e-5), None,
                                  shift=0.5)

    assert torch.autograd.gradcheck(fn, (x, w, b, s, sh))
    out, total = fn(x, w, b, s, sh)
    assert out.grad_fn is not None and total.dtype == torch.float64


def _kernel_cases():
    g = torch.Generator().manual_seed(1)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).requires_grad_()

    s, hd, heads = 8, 16, 2
    c = heads * hd
    qkv = r(2, s, s, 3 * c)
    rel_w = r(2 * 4 - 1, hd, scale=0.3)
    rel_g = r(2 * s - 1, hd, scale=0.3)
    keys, pe = r(2, 12, 32), r(12, 32)
    t2i = {"qp": r(6, 5, 16), "wk": r(32, 16), "bk": r(16), "wv": r(32, 16), "bv": r(16)}
    return {
        "gemm_bf16": (tln.gemm_plain, (r(6, 32), r(32, 8), r(8)),
                      dict(a2=r(6, 32), ln=(r(32), r(32), 1e-6), gelu=True, r1=r(6, 8))),
        "layer_norm": (tln.layer_norm_plain, (r(4, 32), r(32), r(32), 1e-6),
                       dict(residual=r(4, 32))),
        "window_attention": (tfa.window_attention_plain, (qkv, rel_w, rel_w, heads, 4), {}),
        "flash_attention_relpos": (tfa.relpos_attention_plain,
                                   (qkv.reshape(2, s * s, 3 * c)[..., :c][:, 2 * s:4 * s],
                                    qkv.reshape(2, s * s, 3 * c)[..., c:2 * c],
                                    qkv.reshape(2, s * s, 3 * c)[..., 2 * c:], rel_g, rel_g, s,
                                    2), {}),
        "t2i_shared_attend": (tdec.t2i_shared_attend_plain,
                              (keys, pe, r(6, 5, 16), r(32, 16), r(16), r(32, 16), r(16), 2, 3),
                              {}),
        "i2t_keys_update": (tdec.i2t_keys_update_plain,
                            (keys, pe, r(6, 5, 16), r(6, 5, 16), r(32, 16), r(16), r(16, 32),
                             r(32), r(32), r(32)), dict(heads=2, k_share=3, eps=1e-6, t2i=t2i)),
    }


@pytest.mark.parametrize("name", list(_kernel_cases()))
def test_through_kernel_matches_plain_autograd(name):
    """Each kernel the fine-tune step's forward reaches, with its plain
    version in the kernel's place: the Function's gradients (the plain
    version's autograd, recomputed in fp32) equal autograd of the plain
    version on every input, for a random weighting of every output."""
    plain, args, kwargs = _kernel_cases()[name]
    leaves = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor) and t.requires_grad]

    def grads(out):
        outs = out if isinstance(out, tuple) else (out,)
        g = torch.Generator().manual_seed(7)
        loss = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    want = grads(plain(*args, **kwargs))
    got = grads(tag.through_kernel(plain, plain, *args, **kwargs))
    for gw, gg in zip(want, got):
        assert gw is not None and gg is not None
        np.testing.assert_allclose(gg.numpy(), gw.numpy(), rtol=1e-5, atol=1e-6)


def test_refuse_grad_only_where_autograd_records():
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no gradient"):
        tag.refuse_grad("k", None, x)
    with torch.no_grad():
        tag.refuse_grad("k", x)
    tag.refuse_grad("k", x.detach(), 3)
    assert tag.wants_grad(None, x) and not tag.wants_grad(x.detach())


def test_derived_form_remade_after_in_place_update():
    """``_derived`` keys a weight's kernel form on its version too: an
    optimiser step, ``copy_`` or ``load_state_dict`` into a live module remakes
    it (``ops/fused_ln.py``; the caches of ``tinyvit_attention.py``,
    ``conv2d_fused.py`` and ``_int8_t`` go through it). A form that also reads
    other tensors (``deps``) is remade when they change."""
    w = torch.arange(6.0).reshape(2, 3)
    calls = []

    def make(v):
        calls.append(1)
        return v.t().contiguous()

    first = tln._derived(w, "t", make)
    assert tln._derived(w, "t", make) is first and len(calls) == 1
    w.mul_(2)  # in place: same storage, a new version
    again = tln._derived(w, "t", make)
    assert len(calls) == 2 and torch.equal(again, w.t())
    w.copy_(torch.ones(2, 3))
    assert torch.equal(tln._derived(w, "t", make), torch.ones(3, 2))
    bias = torch.zeros(3)
    dep = tln._derived(w, "d", lambda v: v + bias, deps=(bias,))
    bias.add_(1)
    assert torch.equal(tln._derived(w, "d", lambda v: v + bias, deps=(bias,)), dep + 1)
    with torch.inference_mode():  # an inference tensor keeps no version counter
        inf = torch.ones(2, 2)
        assert torch.equal(tln._derived(inf, "t", make), inf)


# ------------------------------------------------------------ utils/checkpoint.py


def test_checkpoints_cross_packages(tmp_path):
    """A tree saved by either package loads in the other (the same ``"::"``
    keys, None leaves skipped); shapes and missing keys raise as in JAX."""
    tree = init_sam_params(4, sam_tiny_test())
    jckpt.save_params_npz(tree, tmp_path / "jax.npz")
    tckpt.save_params_npz({**tree, "prompt": {**tree["prompt"],
                                              "no_mask": torch.from_numpy(tree["prompt"]
                                                                          ["no_mask"])}},
                          tmp_path / "port.npz")
    for src, loader in (("jax", tckpt.load_params_npz), ("port", jckpt.load_params_npz),
                        ("port", tckpt.load_params_npz), ("jax", jckpt.load_params_npz)):
        back = loader(tmp_path / f"{src}.npz", tree)
        assert back["prompt"]["mask_embed"] is None
        flat, want = tckpt.flatten_tree(back), tckpt.flatten_tree(tree)
        assert set(flat) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(flat[key], value, err_msg=key)
    assert set(np.load(tmp_path / "jax.npz").files) == set(np.load(tmp_path / "port.npz").files)
    bad = {**tree, "shared_pe": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="shape mismatch for shared_pe"):
        tckpt.load_params_npz(tmp_path / "jax.npz", bad)
    with pytest.raises(KeyError, match="checkpoint missing parameter extra"):
        tckpt.load_params_npz(tmp_path / "jax.npz", {**tree, "extra": np.zeros(1)})


def test_save_params_without_orbax(tmp_path):
    """``save_params`` writes ``.npz`` (a path without that suffix gets it, as
    the JAX module does where orbax does not import); ``load_params`` finds
    it, and a directory load raises."""
    tree = {"a": [np.arange(3.0)], "b": {"c": np.ones((2, 2), np.float32)}}
    tckpt.save_params(tree, tmp_path / "ckpt")
    assert (tmp_path / "ckpt.npz").exists()
    back = tckpt.load_params(tmp_path / "ckpt", tree)
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(jckpt.load_params(tmp_path / "ckpt", tree)["a"][0],
                                  tree["a"][0])
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ImportError, match="orbax"):
        tckpt.load_params(tmp_path / "orbax", tree)
