"""The port's kernel modules against the JAX package, on the CPU.

On the CPU every kernel wrapper of ``yolo_sam_inference_tpu_torch`` takes its
plain PyTorch version; these tests hold that version against the JAX
package's Pallas kernels in interpret mode (as ``tests/test_fused_ln.py`` and
``tests/test_flash_attention.py`` run them) and against the JAX plain path,
in fp32, on the same numpy inputs. The CUDA kernels themselves are compared
with the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_sam_inference_tpu.ops import flash_attention as jfa
from yolo_sam_inference_tpu.ops import fused_ln as jln
from yolo_sam_inference_tpu.models.sam import model as jsam
from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
from yolo_sam_inference_tpu_torch.ops.flash_attention import (
    relpos_grid_attention,
    window_attention,
    window_attention_plain,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ln_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32),
            (0.1 * rng.normal(size=(c,))).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 4, 4, 256), (3, 7, 64), (5, 48)])
def test_layer_norm_matches_jax(shape):
    x, r, s, b = _ln_inputs(0, shape)
    got = tln.layer_norm(_t(x), _t(s), _t(b), 1e-6)
    kern = jln.fused_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-6, interpret=True)
    plain = jsam._layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)}, jnp.asarray(x), 1e-6)
    # fp32 both sides, same two-pass statistics: only summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), rtol=1e-5, atol=1e-5)


def test_add_layer_norm_matches_jax():
    x, r, s, b = _ln_inputs(1, (2, 8, 8, 256))
    y, ln = tln.layer_norm(_t(x), _t(s), _t(b), 1e-6, residual=_t(r))
    jy, jl = jln.fused_add_ln(jnp.asarray(x), jnp.asarray(r), jnp.asarray(s), jnp.asarray(b),
                              eps=1e-6, interpret=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))  # one fp32 add, exact
    np.testing.assert_allclose(ln.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_fused_ln_matmul_matches_jax():
    x, _, s, b = _ln_inputs(2, (2, 8, 8, 64))
    rng = np.random.default_rng(3)
    w = (rng.normal(size=(64, 192)) / 8).astype(np.float32)
    wb = (0.1 * rng.normal(size=(192,))).astype(np.float32)
    got = tln.fused_ln_matmul(_t(x), _t(s), _t(b), _t(w), _t(wb), eps=1e-6).numpy()
    kern = jln.fused_ln_matmul(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), jnp.asarray(w),
                               jnp.asarray(wb), eps=1e-6, interpret=True)
    p = {"scale": jnp.asarray(s), "bias": jnp.asarray(b)}
    plain = jsam._layer_norm(p, jnp.asarray(x), 1e-6) @ jnp.asarray(w) + jnp.asarray(wb)
    # fp32 K=64 dot products: ~1e-6 relative, bounded loosely for sum order
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(plain), rtol=1e-4, atol=1e-5)


def test_fused_ln_mlp_matches_jax():
    x, a, s, b = _ln_inputs(4, (2, 8, 8, 64))
    rng = np.random.default_rng(5)
    w1 = (rng.normal(size=(64, 256)) / 8).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(256,))).astype(np.float32)
    w2 = (rng.normal(size=(256, 64)) / 16).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    got = tln.fused_ln_mlp(_t(x), _t(a), _t(s), _t(b), _t(w1), _t(b1), _t(w2), _t(b2),
                           eps=1e-6).numpy()
    args = [jnp.asarray(v) for v in (x, a, s, b, w1, b1, w2, b2)]
    kern = jln.fused_ln_mlp(*args, eps=1e-6, interpret=True)
    y = args[0] + args[1]
    h = jsam._layer_norm({"scale": args[2], "bias": args[3]}, y, 1e-6) @ args[4] + args[5]
    plain = y + jax.nn.gelu(h, approximate=False) @ args[6] + args[7]
    # exact erf on both plain paths: fp32 rounding only
    np.testing.assert_allclose(got, np.asarray(plain), rtol=1e-4, atol=2e-5)
    # the interpret-mode TPU kernel uses a rational erf (|err| <= 3.4e-5, GELU
    # <= 1e-4 per unit, fused_ln.py:101-148) summed over 256 hidden units
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-3, atol=3e-4)


def test_fused_ln_mlp_tiled_matches_jax_at_vit_l_width():
    """K10 at ViT-L's MLP (C = 1024, hidden 4096), 16 rows: the JAX tile
    rule splits the hidden into 8 tiles of 512 here, so the interpret-mode
    kernel sums the tiles into one fp32 accumulator; the port computes the
    same function with K4's route."""
    x, a, s, b = _ln_inputs(20, (2, 8, 1024))
    rng = np.random.default_rng(21)
    w1 = (rng.normal(size=(1024, 4096)) / 32).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(4096,))).astype(np.float32)
    w2 = (rng.normal(size=(4096, 1024)) / 64).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(1024,))).astype(np.float32)
    got = tln.fused_ln_mlp(*[_t(v) for v in (x, a, s, b, w1, b1, w2, b2)]).numpy()
    args = [jnp.asarray(v) for v in (x, a, s, b, w1, b1, w2, b2)]
    kern = jln.fused_ln_mlp_tiled(*args, eps=1e-6, interpret=True)
    y = args[0] + args[1]
    h = jsam._layer_norm({"scale": args[2], "bias": args[3]}, y, 1e-6) @ args[4] + args[5]
    plain = y + jax.nn.gelu(h, approximate=False) @ args[6] + args[7]
    # exact erf on both plain paths: fp32 rounding over K = 1024 and 4096
    np.testing.assert_allclose(got, np.asarray(plain), rtol=1e-4, atol=2e-5)
    # the rational erf of the TPU kernel (GELU <= 1e-4 per unit) over 4096
    # hidden units of weight ~1/64: as test_fused_ln_mlp_matches_jax's bound
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-3, atol=3e-4)


def _attn_case(seed, b, s, heads, hd, window):
    rng = np.random.default_rng(seed)
    c = heads * hd
    qkv = rng.normal(size=(b, s, s, 3 * c)).astype(np.float32)
    rel_h = (0.3 * rng.normal(size=(2 * window - 1, hd))).astype(np.float32)
    rel_w = (0.3 * rng.normal(size=(2 * window - 1, hd))).astype(np.float32)
    wproj = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32)
    bproj = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    return qkv, rel_h, rel_w, wproj, bproj


@pytest.mark.parametrize("s,window,hd", [(8, 4, 16), (8, 8, 16), (4, 2, 16), (4, 4, 80)])
def test_window_attention_matches_jax_grid_kernels(s, window, hd):
    heads = 3
    qkv, rel_h, rel_w, wproj, bproj = _attn_case(6, 2, s, heads, hd, window)
    h = window_attention(_t(qkv), _t(rel_h), _t(rel_w), heads, window)
    got = tln.linear(h, _t(wproj), _t(bproj)).numpy()
    rhw = jfa.relpos_tables(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w),
                            heads=heads, window=window, interpret=True)
    want = jfa.flash_attention_grid(jnp.asarray(qkv), rhw, heads=heads, window=window,
                                    wproj=jnp.asarray(wproj), bproj=jnp.asarray(bproj),
                                    interpret=True)
    # the TPU kernel's default softmax exponentiates bf16-rounded logits (clamp
    # mode, flash_attention.py:398-403), so fp32 inputs agree to ~1e-3 only
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-3, atol=3e-3)


def _window_mode_as_the_kernel_addresses_it(qkv, rel_h, rel_w, heads, window):
    """K3 as the window mode of K12's kernel computes it: each (image, window)
    unit gathers its queries, keys and values from the whole grid by the
    kernel's token map (query i of window (wx, wy) at grid position
    (wx w + i % w, wy w + i // w)), runs K12's plain version over the w x w
    grid in window-local coordinates, and writes its output back in place."""
    b, s, _, c3 = qkv.shape
    w, nw = window, s // window
    flat = qkv.reshape(b, s * s, c3)
    out = torch.empty(b, s * s, c3 // 3)
    i = torch.arange(w * w)
    for wy in range(nw):
        for wx in range(nw):
            tok = (wy * w + i // w) * s + wx * w + i % w
            unit = flat[:, tok].reshape(b, w, w, c3)
            out[:, tok] = relpos_grid_attention(unit, rel_h, rel_w, heads,
                                                plain=True).reshape(b, w * w, -1)
    return out.reshape(b, s, s, -1)


@pytest.mark.parametrize("s,window,hd", [(8, 4, 16), (8, 8, 16), (4, 2, 80), (12, 4, 16)])
def test_window_mode_is_k12_over_each_window(s, window, hd):
    """The window attention (K3) is K12's function over each w x w window in
    local coordinates, and both match the JAX grid kernels (interpret mode)."""
    heads = 2
    qkv, rel_h, rel_w, wproj, bproj = _attn_case(11, 2, s, heads, hd, window)
    plain = window_attention_plain(_t(qkv), _t(rel_h), _t(rel_w), heads, window)
    mode = _window_mode_as_the_kernel_addresses_it(_t(qkv), _t(rel_h), _t(rel_w), heads, window)
    torch.testing.assert_close(mode, plain, rtol=1e-5, atol=1e-5)
    rhw = jfa.relpos_tables(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w),
                            heads=heads, window=window, interpret=True)
    want = jfa.flash_attention_grid(jnp.asarray(qkv), rhw, heads=heads, window=window,
                                    wproj=jnp.asarray(wproj), bproj=jnp.asarray(bproj),
                                    interpret=True)
    # the TPU kernel's bf16-rounded exponent (clamp mode) agrees to ~1e-3, as in
    # test_window_attention_matches_jax_grid_kernels
    for h in (plain, mode):
        got = tln.linear(h, _t(wproj), _t(bproj)).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-3, atol=3e-3)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("s,window", [(8, 3), (12, 8)])
def test_window_attention_refuses_a_window_that_does_not_divide_the_grid(device, s, window):
    """The geometry check comes before the dispatch by device, so the CPU path
    and the kernel's path (a non-CPU tensor) refuse alike."""
    heads, hd = 2, 16
    qkv = torch.zeros(1, s, s, 3 * heads * hd, device=device)
    rel = torch.zeros(2 * window - 1, hd, device=device)
    with pytest.raises(ValueError, match="bad geometry"):
        window_attention(qkv, rel, rel, heads, window)


def test_window_attention_matches_jax_naive_path():
    """Against the JAX CPU path: window partition + naive attention
    (``_vision_attention``), q-scaled logits, unscaled-q rel-pos bias."""
    heads, hd, s, window = 2, 16, 4, 2
    c = heads * hd
    _, rel_h, rel_w, wproj, bproj = _attn_case(7, 2, s, heads, hd, window)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, s, s, c)).astype(np.float32)
    wqkv = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    bqkv = (0.1 * rng.normal(size=(3 * c,))).astype(np.float32)
    qkv = _t(x) @ _t(wqkv) + _t(bqkv)
    got = tln.linear(window_attention(qkv, _t(rel_h), _t(rel_w), heads, window),
                     _t(wproj), _t(bproj)).numpy()
    p = {"qkv": {"w": jnp.asarray(wqkv), "b": jnp.asarray(bqkv)},
         "proj": {"w": jnp.asarray(wproj), "b": jnp.asarray(bproj)},
         "rel_pos_h": jnp.asarray(rel_h), "rel_pos_w": jnp.asarray(rel_w)}
    win, padded = jsam._window_partition(jnp.asarray(x), window)
    want = jsam._window_unpartition(
        jsam._vision_attention(p, win, heads, True), window, padded, s
    )
    # fp32 both sides, different contraction order
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_window_attention_plain_is_the_cpu_path():
    qkv, rel_h, rel_w, _, _ = _attn_case(8, 1, 8, 2, 16, 4)
    a = window_attention(_t(qkv), _t(rel_h), _t(rel_w), 2, 4)
    b = window_attention_plain(_t(qkv), _t(rel_h), _t(rel_w), 2, 4)
    assert torch.equal(a, b)


def test_gemm_plain_epilogue_order():
    """gemm_plain: LN prologue over a + a2, bias, GELU, then residual r1 + r2."""
    rng = np.random.default_rng(9)
    a, a2 = (_t(rng.normal(size=(5, 24))) for _ in range(2))
    w, bias = _t(rng.normal(size=(24, 16))), _t(rng.normal(size=(16,)))
    r1, r2 = (_t(rng.normal(size=(5, 16))) for _ in range(2))
    ln = (torch.ones(24), torch.zeros(24), 1e-6)
    got = tln.gemm_bf16(a, w, bias, a2=a2, ln=ln, gelu=True, r1=r1, r2=r2)
    y = torch.nn.functional.layer_norm(a + a2, (24,), eps=1e-6)
    want = r1 + r2 + torch.nn.functional.gelu(y @ w + bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_reject_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        tln.layer_norm(x, torch.ones(8), torch.zeros(8))


def test_kernel_forms_of_weights_are_made_once():
    """fp32 copies of bf16 biases are kept on the tensor, and made again only
    when the tensor's storage changes; fp32 tensors pass through."""
    b = torch.randn(8).to(torch.bfloat16)
    first = tln._f32(b)
    assert first.dtype == torch.float32 and tln._f32(b) is first
    b.data = torch.randn(8).to(torch.bfloat16)  # new storage, as a module .to() gives
    assert tln._f32(b) is not first and torch.equal(tln._f32(b), b.float())
    f = torch.randn(8)
    assert tln._f32(f) is f


def test_int8_weight_form_round_trips_and_is_made_once():
    """The int8 GEMM's B operand: the (out, in) transpose of an (in, out) int8
    weight, K-major as s8 wgmma needs, exact and made once per tensor."""
    wq = torch.randint(-127, 128, (48, 80), dtype=torch.int8)
    wt = tln._int8_t(wq)
    assert wt.shape == (80, 48) and wt.is_contiguous() and torch.equal(wt.t(), wq)
    assert tln._int8_t(wq) is wt
