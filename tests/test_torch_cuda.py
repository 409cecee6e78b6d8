"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports no
jax, so it runs on a machine that has none; ``tests/conftest.py`` imports jax,
so run it there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Kernels take bf16 and accumulate in fp32; the plain versions run in fp32 on
the same bf16 inputs (TF32 off). Bounds are 2% of the output range for the
products (bf16 operands and outputs) and 1% for the LayerNorm (one bf16
rounding of an O(1) output). The int8 kernels are held against their plain
int8 versions on the same bf16 inputs, whose integer products are exact:
see ``_close_int8``.
"""

import pytest
import torch

from yolo_sam_inference_tpu_torch.ops import conv2d_fused as tcv
from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
from yolo_sam_inference_tpu_torch.ops import fused_ln as tln
from yolo_sam_inference_tpu_torch.ops import quant as tq
from yolo_sam_inference_tpu_torch.ops.flash_attention import (
    flash_attention_relpos,
    relpos_attention_plain,
    window_attention,
    window_attention_plain,
)
from yolo_sam_inference_tpu_torch.ops import dw_ln_mlp as tdw
from yolo_sam_inference_tpu_torch.ops import mbconv_fused as tmb
from yolo_sam_inference_tpu_torch.ops import tinyvit_attention as ttv
from yolo_sam_inference_tpu_torch.ops.hull_support import support_points, support_points_plain
from yolo_sam_inference_tpu_torch.ops.window_crop import window_crop, window_crop_plain


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)


def _close(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= rtol * want.float().abs().max().item(), err


def _close_int8(got, want):
    """Kernel vs plain int8 version, both rounding to bf16: an LN value on an
    int8 rounding boundary may resolve the other way after a last-bit
    difference in the fp32 LN statistics (another summation order) and move
    its row by one quantisation step (tests/test_quant.py:197-208). Rows
    beyond one bf16 step of their largest value are at most 10% of the rows,
    and no element is off by more than 2% of the output range."""
    d = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    row_tol = want.float().abs().amax(-1, keepdim=True) * 2 ** -7
    bad_rows = (d > row_tol).any(-1).float().mean().item()
    assert bad_rows <= 0.1, bad_rows
    assert d.max().item() <= 2e-2 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("window,hd,s,std_qk", [
    (16, 64, 32, 1.0), (32, 64, 32, 1.0), (16, 80, 32, 1.0), (32, 80, 32, 1.0),
    (48, 64, 48, 1.0), (64, 64, 64, 1.0), (48, 80, 48, 1.0), (64, 80, 64, 1.0),
    (32, 64, 64, 1.0), (32, 80, 64, 1.0),  # four windows an image at a global width
    (16, 64, 32, 3.0), (16, 80, 48, 2.8), (64, 80, 64, 2.8)])  # logits of |s| ~ 30
def test_window_attention_vs_plain(gen, window, hd, s, std_qk):
    """Windows 16 and 32 on a 32 x 32 grid (and 16 on 48 x 48); 48 and 64
    (the global layers of the 768 and 1024 canvases) on one window of that
    size; 32 on a 64 x 64 grid. K12's kernel runs all but windows of 16 in its
    window mode (the whole-grid mode where the window is the grid); every
    launch counts on window_attention alone."""
    heads = 12 if hd == 64 else 16
    c = heads * hd
    qkv = _randn(gen, 2, s, s, 3 * c)
    qkv[..., :2 * c] *= std_qk
    rel_h, rel_w = (_randn(gen, 2 * window - 1, hd, std=0.3) for _ in range(2))
    if std_qk > 1:  # the first window's first head
        qh, kh = (qkv[:1, :window, :window, i * c:i * c + hd].reshape(1, -1, hd) for i in (0, 1))
        assert _max_logit(qh, kh, hd) >= 25
    before, k12 = window_attention.launches, flash_attention_relpos.launches
    got = window_attention(qkv, rel_h, rel_w, heads, window)
    assert window_attention.launches == before + 1
    assert flash_attention_relpos.launches == k12
    _close(got, window_attention_plain(qkv.float(), rel_h, rel_w, heads, window), 2e-2)


def _max_logit(q, k, hd):
    """The largest |q.k / sqrt(hd)| over the first image's keys."""
    return (q[:1].float() @ k[:1].float().transpose(1, 2)).abs().max().item() * hd ** -0.5


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd,rows,std_qk", [(14, 64, 14, 1.0), (14, 80, 7, 3.0),
                                              (40, 64, 40, 1.0), (28, 80, 14, 1.0),
                                              (64, 80, 32, 1.0), (64, 64, 64, 3.2)])
def test_flash_attention_relpos_vs_plain(gen, s, hd, rows, std_qk):
    """K12 from a fused qkv (B, S*S, 3C): q the last ``rows`` grid rows (a
    rank's share, row0 = S - rows, or the whole grid), k and v its thirds.
    N = 196 and 784 leave partial key tiles, NQ = 98 a partial query tile;
    std_qk 3 gives logits of |s| ~ 30-50."""
    heads, b = 2, 3
    c, n, nq, row0 = heads * hd, s * s, rows * s, s - rows
    qkv = _randn(gen, b, n, 3 * c)
    qkv[..., :2 * c] *= std_qk
    rel_h, rel_w = (_randn(gen, 2 * s - 1, hd, std=0.3) for _ in range(2))
    q, k, v = qkv[:, row0 * s:, :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    before = flash_attention_relpos.launches
    got = flash_attention_relpos(q, k, v, rel_h, rel_w, s, row0=row0)
    assert flash_attention_relpos.launches == before + 1
    assert got.shape == (b, nq, c)
    _close(got, relpos_attention_plain(q.float(), k.float(), v.float(), rel_h, rel_w, s, row0),
           2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd,rows", [(14, 64, 7), (14, 80, 7), (40, 64, 20), (40, 80, 20),
                                       (64, 64, 32), (64, 80, 32)])
def test_flash_attention_relpos_on_gathered_kv_vs_plain(gen, s, hd, rows):
    """K12 as the sequence-parallel global layer calls it: q a view of rank
    1's own qkv (row0 = rows), k and v views of the gathered k | v half
    (token stride 2C), at logits of |s| ~ 30-58."""
    heads, b = 2, 2
    c, n, row0 = heads * hd, s * s, rows
    std = 3.0 if hd == 64 else 2.8
    own = _randn(gen, b, rows * s, 3 * c)
    own[..., :c] *= std
    kv = _randn(gen, b, n, 2 * c)
    kv[..., :c] *= std
    rel_h, rel_w = (_randn(gen, 2 * s - 1, hd, std=0.3) for _ in range(2))
    q, k, v = own[..., :c], kv[..., :c], kv[..., c:]
    qh, kh = (t.reshape(b, -1, heads, hd).transpose(1, 2).reshape(b * heads, -1, hd)
              for t in (q, k))
    assert _max_logit(qh, kh, hd) >= 30
    got = flash_attention_relpos(q, k, v, rel_h, rel_w, s, row0=row0)
    _close(got, relpos_attention_plain(q.float(), k.float(), v.float(), rel_h, rel_w, s, row0),
           2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("canvas,window", [(512, 16), (448, 14)])
def test_sp_encoder_two_ranks_on_the_card(gen, tmp_path, canvas, window):
    """The sequence-parallel encoder at ViT-B widths (2 layers: windowed,
    global) over 2 gloo ranks sharing the card, at grid 32 with window 16 and
    at grid 28 with window 14 (each rank's windows on K12; the single card
    takes the flat route there): the ranks agree bit for bit and stay within
    2% relative RMS of the single-card bf16 encoder (other kernels for the
    global layer: K12, not K3)."""
    import dataclasses

    import numpy as np

    from yolo_sam_inference_tpu_torch.models.sam import SamImageEncoder, init_sam_params, sam_vit_b
    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
    from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
    from yolo_sam_inference_tpu_torch.weights import save_tree

    cfg = dataclasses.replace(sam_vit_b(canvas), vision_layers=2, global_attn_indexes=(1,),
                              window_size=window)
    rng = np.random.default_rng(0)
    tree = {"vision": init_sam_params(0, cfg)["vision"]}
    for lp in tree["vision"]["layers"]:
        for key in ("rel_pos_h", "rel_pos_w"):
            lp["attn"][key] = (0.3 * rng.normal(size=lp["attn"][key].shape)).astype(np.float32)
    pix = rng.normal(size=(2, canvas, canvas, 3)).astype(np.float32)
    save_tree(tmp_path / "t.npz", tree)
    np.save(tmp_path / "p.npy", pix)
    job = {"kind": "encoder", "tree": str(tmp_path / "t.npz"), "cfg": cfg,
           "pix": str(tmp_path / "p.npy"), "out": str(tmp_path / "e"), "device": "cuda",
           "dtype": torch.bfloat16}
    assert run_ranks(run_jobs, 2, ([job],)) == ("nccl" if torch.cuda.device_count() >= 2
                                                else "gloo")
    a, b = (np.load(tmp_path / f"e.rank{r}.npy") for r in range(2))
    np.testing.assert_array_equal(a, b)
    enc = SamImageEncoder(tree["vision"], cfg).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        want = enc(torch.from_numpy(pix).to("cuda", torch.bfloat16)).float().cpu().numpy()
    assert np.linalg.norm(a - want) / np.linalg.norm(want) < 0.02


def _int8_weight(gen, i, o):
    return tq.quantize_weight(_randn(gen, i, o, std=i ** -0.5, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("c,rows", [(1024, 1000), (1280, 1000), (768, 100)])
def test_fused_ln_matmul_int8_vs_plain(gen, c, rows):
    """ViT-L/H and ViT-B (768 -> 2304) widths; rows not a multiple of the
    128-row tile, or fewer than one tile."""
    x = _randn(gen, rows, c)
    s = 1.0 + _randn(gen, c, std=0.1, dtype=torch.float32)
    b = _randn(gen, c, std=0.1, dtype=torch.float32)
    wq, ws = _int8_weight(gen, c, 3 * c)
    bq = _randn(gen, 3 * c, std=0.1, dtype=torch.float32)
    before = tln.fused_ln_matmul_int8.launches
    got = tln.fused_ln_matmul_int8(x, s, b, wq, ws, bq)
    assert tln.fused_ln_matmul_int8.launches == before + 1
    _close_int8(got, tln.fused_ln_matmul_int8_plain(x, s, b, wq, ws, bq))


@pytest.mark.cuda
@pytest.mark.parametrize("c,o,gelu,rows", [(768, 2304, False, 1000), (768, 3072, True, 1000),
                                         (3072, 768, False, 1000), (768, 2304, False, 100)])
def test_int8_linear_vs_plain(gen, c, o, gelu, rows):
    """The flat route's int8 qkv, mlp1 (+ GELU) and mlp2 at ViT-B widths:
    the LN-less row quantisation and one int8 GEMM."""
    x = _randn(gen, rows, c)
    wq, ws = _int8_weight(gen, c, o)
    b = _randn(gen, o, std=0.1, dtype=torch.float32)
    before = tln.int8_linear.launches
    got = tln.int8_linear(x, wq, ws, b, gelu=gelu)
    assert tln.int8_linear.launches == before + 1
    _close_int8(got, tln.int8_linear_plain(x, wq, ws, b, gelu=gelu))


@pytest.mark.cuda
@pytest.mark.parametrize("c,hidden,tiled,attn,rows", [(1024, 4096, False, True, 1000),
                                                      (1024, 4096, False, False, 1000),
                                                      (1280, 5120, True, True, 1000),
                                                      (768, 3072, False, True, 100),
                                                      (768, 3072, True, True, 1000)])
def test_int8_tails_vs_plain(gen, c, hidden, tiled, attn, rows):
    """K11a (ViT-L) with and without the attention residual, K11b (ViT-H),
    and the ViT-B tail (768 / 3072) at 100 rows (under one tile) and tiled."""
    x, h = _randn(gen, rows, c), (_randn(gen, rows, c) if attn else None)
    s = 1.0 + _randn(gen, c, std=0.1, dtype=torch.float32)
    b = _randn(gen, c, std=0.1, dtype=torch.float32)
    w1q, w1s = _int8_weight(gen, c, hidden)
    w2q, w2s = _int8_weight(gen, hidden, c)
    b1, b2 = (_randn(gen, n, std=0.1, dtype=torch.float32) for n in (hidden, c))
    fn = tln.fused_ln_mlp_tiled_int8 if tiled else tln.fused_ln_mlp_int8
    before = fn.launches
    got = fn(x, h, s, b, w1q, w1s, b1, w2q, w2s, b2)
    assert fn.launches == before + 1
    chunks = tln.int8_tail_chunks(rows, c, hidden, tiled)
    _close_int8(got, tln.fused_ln_mlp_int8_plain(x, h, s, b, w1q, w1s, b1, w2q, w2s, b2,
                                                 chunks=chunks))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [768, 1024, 1280])  # ViT-B, L, H (K1, K4 / K10)
def test_fused_ln_matmul_and_mlp_vs_plain(gen, c):
    rows, hidden = 1000, 4 * c  # rows: not a multiple of the 128-row tile
    x, h = _randn(gen, rows, c), _randn(gen, rows, c)
    s = 1.0 + _randn(gen, c, std=0.1, dtype=torch.float32)
    b = _randn(gen, c, std=0.1, dtype=torch.float32)
    wq, bq = _randn(gen, c, 3 * c, std=c ** -0.5), _randn(gen, 3 * c, dtype=torch.float32)
    w1, b1 = _randn(gen, c, hidden, std=c ** -0.5), _randn(gen, hidden, dtype=torch.float32)
    w2, b2 = _randn(gen, hidden, c, std=hidden ** -0.5), _randn(gen, c, dtype=torch.float32)
    before = tln.gemm_bf16.launches
    _close(tln.fused_ln_matmul(x, s, b, wq, bq),
           tln.fused_ln_matmul(x.float(), s, b, wq, bq, gemm=tln.gemm_plain), 2e-2)
    _close(tln.fused_ln_mlp(x, h, s, b, w1, b1, w2, b2),
           tln.fused_ln_mlp(x.float(), h.float(), s, b, w1, b1, w2, b2, gemm=tln.gemm_plain),
           2e-2)
    assert tln.gemm_bf16.launches == before + 3


_GEMM_MODES = ("bias", "ln", "a2", "ln a2 gelu", "gelu", "r1", "r1 r2")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", _GEMM_MODES)
@pytest.mark.parametrize("m,k,n", [(3584, 264, 136), (100, 768, 2304), (2048, 64, 192),
                                   (1024, 160, 640), (512, 320, 960)])
def test_gemm_bf16_modes_vs_plain(gen, m, k, n, mode):
    """Every mode of the GEMM at ragged M, N and K (264 and 136: neither a
    multiple of the 64-wide k-tile nor of the 128-wide n-tile), a short M of
    100 rows, and TinyViT's widths 64 / 160 / 320 (qkv and MLP)."""
    a, w = _randn(gen, m, k), _randn(gen, k, n, std=k ** -0.5)
    bias = _randn(gen, n, std=0.1, dtype=torch.float32)
    kw = {}
    if "ln" in mode:
        kw["ln"] = (1.0 + _randn(gen, k, std=0.1, dtype=torch.float32),
                    _randn(gen, k, std=0.1, dtype=torch.float32), 1e-6)
    if "a2" in mode:
        kw["a2"] = _randn(gen, m, k)
    if "gelu" in mode:
        kw["gelu"] = True
    if "r1" in mode:
        kw["r1"] = _randn(gen, m, n)
    if "r2" in mode:
        kw["r2"] = _randn(gen, m, n)
    before = tln.gemm_bf16.launches
    got = tln.gemm_bf16(a, w, bias, **kw)
    assert tln.gemm_bf16.launches == before + 1
    ref = {key: (v.float() if isinstance(v, torch.Tensor) else v) for key, v in kw.items()}
    _close(got, tln.gemm_plain(a.float(), w, bias, **ref), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,c", [(4096, 256), (5000, 64), (4101, 256), (517, 768),
                                    (301, 1024), (255, 1280)])
def test_layer_norm_vs_plain(gen, rows, c):
    """Both forms at every C of the paths (64 the mask head, 256 the necks and
    the decoder, 768 ViT-B's flat route; 1024 and 1280 the wider ViTs), row
    counts that leave a partial block of rows."""
    x, r = _randn(gen, rows, c), _randn(gen, rows, c)
    s = 1.0 + _randn(gen, c, std=0.1, dtype=torch.float32)
    b = _randn(gen, c, std=0.1, dtype=torch.float32)
    before = (tln.layer_norm.launches, tln.layer_norm.residual_launches)
    _close(tln.layer_norm(x, s, b, 1e-6), tln.layer_norm_plain(x.float(), s, b, 1e-6), 1e-2)
    y, ln = tln.layer_norm(x, s, b, 1e-6, residual=r)
    y_ref, ln_ref = tln.layer_norm_plain(x.float(), s, b, 1e-6, residual=r.float())
    _close(y, y_ref, 1e-2)
    _close(ln, ln_ref, 1e-2)
    # the plain form (K5) and the residual form (K11d) count apart
    assert (tln.layer_norm.launches, tln.layer_norm.residual_launches) == (before[0] + 1,
                                                                          before[1] + 1)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    qkv = _randn(gen, 1, 32, 32, 3 * 768)
    rel = _randn(gen, 31, 64)
    with pytest.raises(ValueError, match="bf16"):
        window_attention(qkv.float(), rel, rel, 12, 16)
    with pytest.raises(ValueError, match="hd=64"):
        window_attention(qkv, _randn(gen, 31, 96), _randn(gen, 31, 96), 8, 16)
    qkv48 = _randn(gen, 1, 48, 48, 3 * 768)
    with pytest.raises(ValueError, match="window 16, 32, 48"):  # a window still refused
        window_attention(qkv48, _randn(gen, 47, 64), _randn(gen, 47, 64), 12, 24)
    with pytest.raises(ValueError, match="bad geometry"):  # a window that does not divide S
        window_attention(qkv48, _randn(gen, 63, 64), _randn(gen, 63, 64), 12, 32)
    with pytest.raises(ValueError, match="ws 7 or 14"):
        ttv.tinyvit_attention(_randn(gen, 1, 8, 8, 384), _randn(gen, 384),
                              _randn(gen, 4, 81), 4, 5)
    gemms = tln.gemm_bf16.launches
    for c, heads, ws in ((128, 4, 5), (320, 10, 5), (128, 2, 7)):  # refused before any launch
        with pytest.raises(ValueError, match="ws 7 or 14"):
            ttv.tinyvit_window_block(_randn(gen, 1, 8, 8, c), _randn(gen, heads, (2 * ws - 1) ** 2),
                                     *_tv_block_weights(gen, c), heads, ws)
    assert tln.gemm_bf16.launches == gemms
    with pytest.raises(ValueError, match="stride-1 MBConv kernel takes"):
        tmb.mbconv_block(_randn(gen, 1, 8, 8, 48), _randn(gen, 48, 192), _randn(gen, 192),
                         _randn(gen, 3, 3, 192), _randn(gen, 192), _randn(gen, 192, 48),
                         _randn(gen, 48))
    with pytest.raises(ValueError, match="multiples of 8"):
        tln.gemm_bf16(_randn(gen, 16, 12), _randn(gen, 12, 16))
    q = _randn(gen, 1, 64, 192)
    with pytest.raises(ValueError, match="hd=64 or hd=80"):
        flash_attention_relpos(q, q, q, _randn(gen, 15, 96), _randn(gen, 15, 96), 8)
    t = _randn(gen, 15, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_relpos(q[..., :128], q[..., :128], q[..., :128], t, t, 8)
    for c in (100, 128):  # off the paths' widths, a multiple of 8 or not
        with pytest.raises(ValueError, match="takes C in"):
            tln.layer_norm(_randn(gen, 4, c), _randn(gen, c), _randn(gen, c))


def _decoder_weights(gen, c=256, dh=128):
    w = lambda i, o: _randn(gen, i, o, std=i ** -0.5)
    b = lambda o: _randn(gen, o, std=0.1, dtype=torch.float32)
    return {"wq": w(c, dh), "bq": b(dh), "wout": w(dh, c), "bout": b(c),
            "ln_s": 1.0 + b(c), "ln_b": b(c), "wk": w(c, dh), "bk": b(dh),
            "wv": w(c, dh), "bv": b(dh)}


@pytest.mark.cuda
@pytest.mark.parametrize("i2t,k_share,t,tq,tq2", [
    (True, 4, 256, 7, 7), (True, 1, 256, 7, 7), (False, 1, 256, 7, 7),
    (True, 16, 196, 5, 8), (True, 1, 4096, 8, 5), (True, 2, 784, 8, 8),
    (False, 1, 196, 7, 7), (False, 1, 4096, 7, 7)])
def test_keys_stream_vs_plain(gen, i2t, k_share, t, tq, tq2):
    """keys_stream: the i2t pass with the next attention split over its
    128-token tiles and joined by t2i_combine (K7), or the k/v projection pass
    (K6). T 196 and 784: a short last tile; 4096: 32 tiles; k_share 16:
    layer 0's prompts sharing their image's keys; tq and tq2 up to 8."""
    nsrc = 3 if t < 4096 else 2
    n = nsrc * k_share
    p = _decoder_weights(gen)
    keys, pe = _randn(gen, nsrc, t, 256), _randn(gen, t, 256)
    before = dec.keys_stream.launches, dec.t2i_combine.launches
    if not i2t:
        got = dec.kv_project(keys, pe, p["wk"], p["bk"], p["wv"], p["bv"], 8)
        want = dec.kv_project_plain(keys.float(), pe.float(), p["wk"], p["bk"], p["wv"], p["bv"])
    else:
        kq, vq = _randn(gen, n, tq, 128), _randn(gen, n, tq, 128)
        qn = _randn(gen, n, tq2, 128, std=0.25)
        w = (p["wq"], p["bq"], p["wout"], p["bout"], p["ln_s"], p["ln_b"])
        nxt = {"wk": p["wk"], "bk": p["bk"], "wv": p["wv"], "bv": p["bv"]}
        got = dec.i2t_keys_update(keys, pe, kq, vq, *w, heads=8, k_share=k_share,
                                  t2i={"qp": qn, **nxt})
        want = dec.i2t_keys_update_plain(keys.float(), pe.float(), kq.float(), vq.float(), *w,
                                         heads=8, k_share=k_share,
                                         t2i={"qp": qn.float(), **nxt})
    assert dec.keys_stream.launches == before[0] + 1
    assert dec.t2i_combine.launches == before[1] + int(i2t)
    for g_, w_ in zip(got, want):
        _close(g_, w_, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("gs", [14, 28])
def test_decoder_kernels_at_short_tiles(gen, gs):
    """keys_stream (both modes), t2i_combine and t2i_attend on grids of 14
    and 28 (T = 196, 784: the last 128-token tile is short)."""
    nsrc, k_share, t, tq = 2, 4, gs * gs, 7
    n = nsrc * k_share
    p = _decoder_weights(gen)
    keys, pe = _randn(gen, nsrc, t, 256), _randn(gen, t, 256)
    kq, vq = _randn(gen, n, tq, 128), _randn(gen, n, tq, 128)
    qn = _randn(gen, n, tq, 128, std=0.25)
    w = (p["wq"], p["bq"], p["wout"], p["bout"], p["ln_s"], p["ln_b"])
    nxt = {"wk": p["wk"], "bk": p["bk"], "wv": p["wv"], "bv": p["bv"]}
    before = dec.keys_stream.launches, dec.t2i_combine.launches, dec.t2i_attend.launches
    got = dec.i2t_keys_update(keys, pe, kq, vq, *w, heads=8, k_share=k_share,
                              t2i={"qp": qn, **nxt})
    want = dec.i2t_keys_update_plain(keys.float(), pe.float(), kq.float(), vq.float(), *w,
                                     heads=8, k_share=k_share, t2i={"qp": qn.float(), **nxt})
    for g_, w_ in zip(got, want):
        _close(g_, w_, 2e-2)
    kp, vp = dec.kv_project(keys, pe, p["wk"], p["bk"], p["wv"], p["bv"], 8)
    for g_, w_ in zip((kp, vp), dec.kv_project_plain(keys.float(), pe.float(), p["wk"], p["bk"],
                                                     p["wv"], p["bv"])):
        _close(g_, w_, 2e-2)
    _close(dec.t2i_attend(qn, kp, vp, 8, k_share),
           dec.t2i_attend_plain(qn.float(), kp.float(), vp.float(), 8, k_share), 2e-2)
    assert (dec.keys_stream.launches, dec.t2i_combine.launches, dec.t2i_attend.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("t,k_share", [(t, k) for t in (196, 784, 1024, 4096) for k in (1, 16)]
                         + [(784, 36), (1024, 50)])
def test_t2i_attend_vs_plain(gen, t, k_share):
    """T: the grids of 14, 28, 32 and 64 (short last key tile at 196 and
    784); k_share 1 (7 rows: one warp), 16 (config 1: 112 rows), 36 and 50
    (252 and 350 rows: four row tiles a warp, the last warp's partly empty)."""
    nsrc, tq = 3, 7
    qp = _randn(gen, nsrc * k_share, tq, 128, std=0.5)
    kp, vp = _randn(gen, nsrc, t, 128), _randn(gen, nsrc, t, 128)
    before = dec.t2i_attend.launches
    got = dec.t2i_attend(qp, kp, vp, 8, k_share)
    assert dec.t2i_attend.launches == before + 1
    _close(got, dec.t2i_attend_plain(qp.float(), kp.float(), vp.float(), 8, k_share), 2e-2)


@pytest.mark.cuda
def test_window_crop_vs_plain(gen):
    grid = _randn(gen, 10, 32, 32, 256)
    r0 = torch.randint(-2, 30, (10,), generator=gen).cuda()  # clamped to [0, 21]
    c0 = torch.randint(0, 22, (10,), generator=gen).cuda()
    before = window_crop.launches
    got = window_crop(grid, r0, c0, 11)
    assert window_crop.launches == before + 1
    assert torch.equal(got, window_crop_plain(grid, r0, c0, 11))  # a copy: exact


@pytest.mark.cuda
def test_support_points_vs_plain(gen):
    n, p, d = 20, 512, 256
    pts = (torch.randint(0, 128, (n, p, 2), generator=gen).float() - 0.5).cuda()
    pts[:, ::7] = pts[:, 3:4]  # repeated candidates: exact score ties
    ang = torch.arange(d, dtype=torch.float64) * (2 * torch.pi / d)
    dirs = torch.stack([ang.cos(), ang.sin()], 1).float().cuda()
    before = support_points.launches
    got = support_points(pts, dirs)
    assert support_points.launches == before + 1
    # the same rounded fp32 scores and the same tie-break: identical points
    assert torch.equal(got, support_points_plain(pts, dirs))


# ---------------------------------------------------------------- MobileSAM


def _f32(gen, *shape, std=1.0):
    return _randn(gen, *shape, std=std, dtype=torch.float32)


def _tv_block_weights(gen, c):
    """LN scale and shift, qkv and projection weights and biases of a window
    block (a large LN shift and qkv bias make the pad-token keys weigh)."""
    return (1.0 + _randn(gen, c, std=0.1), _randn(gen, c, std=0.5),
            _randn(gen, c, 3 * c, std=c ** -0.5), _randn(gen, 3 * c, std=0.3),
            _randn(gen, c, c, std=c ** -0.5), _randn(gen, c, std=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads,ws", [((2, 16, 16, 128), 4, 7), ((2, 15, 15, 160), 5, 14),
                                            ((2, 9, 9, 320), 10, 7), ((1, 14, 14, 128), 4, 7)])
def test_tinyvit_attention_vs_plain(gen, shape, heads, ws):
    """K13's attention kernel: pad tokens (16 -> 21, 15 -> 28, 9 -> 14) read
    the pad row; an exact tiling (14) has none."""
    b, h, w, c = shape
    qkv = _randn(gen, b, h, w, 3 * c)
    pad = _randn(gen, 3 * c)
    table = _randn(gen, heads, (2 * ws - 1) ** 2, std=0.5)
    before = ttv.tinyvit_attention.launches
    got = ttv.tinyvit_attention(qkv, pad, table, heads, ws)
    assert ttv.tinyvit_attention.launches == before + 1
    _close(got, ttv.tinyvit_attention_plain(qkv.float(), pad.float(), table, heads, ws), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads,ws", [((2, 16, 16, 128), 4, 7), ((2, 9, 12, 128), 4, 7),
                                            ((2, 15, 15, 160), 5, 14), ((1, 32, 32, 160), 5, 14),
                                            ((2, 9, 9, 320), 10, 7), ((3, 5, 6, 320), 10, 7),
                                            ((1, 10, 9, 160), 5, 14), ((1, 14, 14, 128), 4, 7),
                                            ((1, 9, 11, 160), 5, 7)])
def test_tinyvit_window_block_vs_reference(gen, shape, heads, ws):
    """K13 at TinyViT-5M's widths (C 128 / 160 / 320, ws 7 and 14) against the
    official pad-then-LN block in fp32: one launch at stage 1 and 2's widths
    (C 128 at ws 7, C 160 at ws 14), the three launches elsewhere (stage 3's C
    320, and C 160 at ws 7); ragged grids (pad tokens as keys, pad-only query
    tiles at 32 x 32 in windows of 14), grids smaller than one window, an odd
    window count (a warpgroup with no window), batch 1, an exact tiling (14 x
    14 at ws 7)."""
    b, h, w, c = shape
    x = _randn(gen, b, h, w, c)
    table = _randn(gen, heads, (2 * ws - 1) ** 2, std=0.5)
    args = (table, *_tv_block_weights(gen, c), heads, ws)
    fused = (ws, c) in ttv.KERNEL_WIDTHS
    counts = (ttv.tinyvit_window_block, ttv.tinyvit_attention, tln.gemm_bf16)
    before = [f.launches for f in counts]
    got = ttv.tinyvit_window_block(x, *args)
    assert [f.launches - n for f, n in zip(counts, before)] == ([1, 0, 0] if fused else [0, 1, 2])
    _close(got, ttv.tinyvit_window_block_reference(x.float(), *args), 2e-2)


@pytest.mark.cuda
def test_tinyvit_window_block_vs_plain(gen):
    """K13 as the encoder runs it: one launch, no gemm_bf16, against the
    pad-then-LN reference and the plain route (LN + qkv, the attention with
    the pad-token row, projection + residual)."""
    b, h, w, c, heads, ws = 2, 16, 16, 128, 4, 7
    x = _randn(gen, b, h, w, c)
    table = _randn(gen, heads, (2 * ws - 1) ** 2, std=0.5)
    args = (table, *_tv_block_weights(gen, c), heads, ws)
    before = ttv.tinyvit_window_block.launches, tln.gemm_bf16.launches
    got = ttv.tinyvit_window_block(x, *args)
    assert (ttv.tinyvit_window_block.launches, tln.gemm_bf16.launches) == (before[0] + 1,
                                                                           before[1])
    _close(got, ttv.tinyvit_window_block_reference(x.float(), *args), 2e-2)
    _close(got, ttv.tinyvit_window_block_plain(x.float(), *args), 2e-2)


def _conv_weights(gen, c, e, co):
    return (_randn(gen, c, e, std=c ** -0.5), _f32(gen, e, std=0.3),
            _randn(gen, 3, 3, e, std=1 / 3), _f32(gen, e, std=0.3),
            _randn(gen, e, co, std=e ** -0.5), _f32(gen, co, std=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,e,co,residual", [((2, 16, 16, 64), 256, 64, True),
                                                 ((1, 10, 12, 64), 256, 64, True),
                                                 ((2, 8, 8, 160), 320, 320, False),
                                                 ((1, 13, 21, 64), 256, 64, True),
                                                 ((2, 9, 11, 160), 320, 320, False),
                                                 ((1, 16, 16, 128), 256, 128, True),
                                                 ((1, 12, 10, 32), 128, 64, False)])
def test_mbconv_vs_plain(gen, shape, e, co, residual):
    """K14: stage 0's MBConv (ragged 10 x 12 and 13 x 21 grids too: the 8 x 8
    tiles do not divide them) and the stride-1 merge2's 160 -> 320 without the
    residual (ragged too); Co 128 (streamed weights with the residual) and
    C 32 (a short k-step group)."""
    x = _randn(gen, *shape)
    w = _conv_weights(gen, shape[-1], e, co)
    before = tmb.mbconv_block.launches
    got = tmb.mbconv_block(x, *w, residual=residual)
    assert tmb.mbconv_block.launches == before + 1
    _close(got, tmb.mbconv_plain(x.float(), *w, stride=1, residual=residual), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co", [((2, 16, 16, 64), 128), ((2, 12, 20, 128), 160),
                                      ((1, 18, 22, 64), 128), ((3, 14, 30, 128), 160),
                                      ((1, 34, 18, 64), 96)])
def test_patch_merge_vs_plain(gen, shape, co):
    """K15: stride-2 merges at merge0's widths (C 64: 3 warpgroups) and
    merge1's (C 128, E and Co 160: a zero-filled half box; 2 warpgroups), both
    on resident weights, with ragged output tiles (6 x 10, 9 x 11, 7 x 15,
    17 x 9) and odd tile counts, and E, Co 96."""
    x = _randn(gen, *shape)
    w = _conv_weights(gen, shape[-1], co, co)
    before = tmb.patch_merge_block.launches
    got = tmb.patch_merge_block(x, *w)
    assert tmb.patch_merge_block.launches == before + 1
    _close(got, tmb.mbconv_plain(x.float(), *w, stride=2, residual=False), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,e,co,stride,residual", [((2, 16, 16, 64), 256, 64, 1, True),
                                                        ((2, 8, 8, 160), 320, 320, 1, False),
                                                        ((1, 13, 21, 64), 256, 64, 1, True),
                                                        ((2, 9, 11, 160), 320, 320, 1, False),
                                                        ((2, 16, 16, 64), 128, 128, 2, False),
                                                        ((2, 12, 20, 128), 160, 160, 2, False),
                                                        ((1, 18, 22, 64), 128, 128, 2, False),
                                                        ((3, 14, 30, 128), 160, 160, 2, False)])
def test_conv_blocks_bf16_compute_vs_plain(gen, shape, e, co, stride, residual):
    """K14 and K15 with compute="bf16": the bf16 instantiation against the
    bf16-compute plain version (2% of the range), and against the fp32 plain
    version within the JAX package's bound for the mode (max 8%, mean 1% of
    max|ref|)."""
    x = _randn(gen, *shape)
    w = _conv_weights(gen, shape[-1], e, co)
    fn = tmb.patch_merge_block if stride == 2 else tmb.mbconv_block
    kw = {} if stride == 2 else {"residual": residual}
    before = fn.launches, fn.bf16_launches
    got = fn(x, *w, compute="bf16", **kw)
    assert (fn.launches, fn.bf16_launches) == (before[0] + 1, before[1] + 1)
    _close(got, tmb.mbconv_plain(x, *w, stride=stride, residual=residual, compute="bf16"), 2e-2)
    ref = tmb.mbconv_plain(x.float(), *w, stride=stride, residual=residual)
    err, scale = (got.float() - ref).abs(), ref.abs().max().item()
    assert err.max().item() <= 0.08 * scale and err.mean().item() <= 0.01 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 13, 19, 128), (2, 15, 9, 160), (1, 9, 7, 320)])
def test_dw_ln_mlp_vs_plain(gen, shape):
    """K16: the one-pass depthwise + LayerNorm kernel (H x W not a multiple
    of its 8 x 8 tile), then the tail (dw + two gemm_bf16). y within 2% of
    range of the fp32 plain depthwise; LN(y) within 1% of range of the plain
    LayerNorm of the kernel's own y (one bf16 rounding of O(1) values)."""
    c = shape[-1]
    x = _randn(gen, *shape)
    wd, bd = _randn(gen, 3, 3, c, std=1 / 3), _f32(gen, c, std=0.3)
    s, b = 1.0 + _f32(gen, c, std=0.1), _f32(gen, c, std=0.1)
    w1, b1 = _randn(gen, c, 4 * c, std=c ** -0.5), _f32(gen, 4 * c, std=0.1)
    w2, b2 = _randn(gen, 4 * c, c, std=(4 * c) ** -0.5), _f32(gen, c, std=0.1)
    before = tdw.dw_conv3x3.launches, tln.gemm_bf16.launches
    _close(tdw.dw_conv3x3(x, wd, bd), tdw.dw_conv3x3_plain(x.float(), wd, bd), 2e-2)
    y, ln_y = tdw.dw_conv3x3(x, wd, bd, ln=(s, b, 1e-5))
    _close(y, tdw.dw_conv3x3_plain(x.float(), wd, bd), 2e-2)
    _close(ln_y, tln.layer_norm_plain(y.float(), s, b, 1e-5), 1e-2)
    got = tdw.dw_ln_mlp(x, wd, bd, s, b, w1, b1, w2, b2)
    assert (tdw.dw_conv3x3.launches, tln.gemm_bf16.launches) == (before[0] + 3, before[1] + 2)
    _close(got, tdw.dw_ln_mlp(x.float(), wd, bd, s, b, w1, b1, w2, b2, gemm=tln.gemm_plain,
                              dw=tdw.dw_conv3x3_plain), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co,k,stride,act,bias,sliced", [
    ((2, 64, 64, 3), 16, 3, 2, "silu", True, False),      # the YOLO stem (small-Ci kernel)
    ((2, 24, 20, 32), 32, 3, 1, "silu", True, True),      # a C2f bottleneck on a channel slice
    ((2, 16, 16, 64), 64, 3, 1, "silu", True, False),     # a detect tower conv
    ((2, 16, 16, 128), 256, 3, 2, "silu", True, False),   # down5
    ((2, 16, 16, 256), 256, 3, 1, "none", False, False),  # the SAM neck, no bias
    ((2, 33, 40, 3), 32, 3, 2, "gelu", True, False),      # TinyViT's stem1, odd H
    ((2, 12, 20, 256), 128, 2, 1, "silu", True, False),   # the s2d k = 2 exit, pad (1, 0)
    ((2, 20, 18, 16), 32, 3, 2, "silu", True, False),     # Ci 16, ragged tiles
    ((2, 19, 23, 16), 16, 3, 1, "silu", True, False),     # Co 16, ragged H x W
    ((2, 21, 13, 32), 48, 3, 1, "gelu", True, False),     # Co 48, ragged H x W
    ((2, 17, 29, 64), 128, 3, 1, "silu", True, True),     # Co 128, ragged, a channel slice
    ((2, 27, 31, 64), 64, 3, 2, "silu", True, False),     # stride 2 at an odd size
    ((1, 12, 12, 32), 320, 3, 1, "none", True, False),    # Co above 256: two column blocks
    ((2, 9, 11, 72), 80, 2, 1, "silu", True, False),      # k 2, Co 80 (a padded weight copy)
    ((2, 30, 34, 3), 16, 3, 2, "silu", True, True),       # a stem on an unaligned slice
    ((1, 9, 67, 5), 8, 2, 1, "gelu", False, False),       # the stems' kernel at k 2, Ci 5
    ((2, 64, 144, 16), 128, 3, 1, "silu", True, False),   # enough tiles for 128 columns a block
    ((2, 128, 144, 16), 256, 3, 1, "none", True, False),  # and for 256
    ((3, 128, 256, 16), 256, 3, 2, "silu", True, False),  # and for 256 at stride 2
])
def test_conv2d_act_vs_plain(gen, shape, co, k, stride, act, bias, sliced):
    """K17 at each geometry of the paths (narrower images, same widths)."""
    b, h, w, ci = shape
    x = _randn(gen, b, h, w, 2 * ci)[..., ci:] if sliced else _randn(gen, *shape)
    wt = _randn(gen, k, k, ci, co, std=(k * k * ci) ** -0.5)
    bb = _f32(gen, co, std=0.3) if bias else None
    before = tcv.conv2d_act.launches
    got = tcv.conv2d_act(x, wt, bb, k, stride, act)
    assert tcv.conv2d_act.launches == before + 1
    assert got.shape == (b, *tcv.output_hw(h, w, k, stride), co)
    _close(got, tcv.conv2d_act_plain(x.float(), wt, bb, k, stride, act), 2e-2)


@pytest.mark.cuda
def test_conv2d_act_refuses_what_the_kernel_does_not_take(gen):
    x, wt = _randn(gen, 1, 8, 8, 16), _randn(gen, 3, 3, 16, 16)
    with pytest.raises(ValueError, match="bf16"):
        tcv.conv2d_act(x.float(), wt, None)
    with pytest.raises(ValueError, match="stride"):
        tcv.conv2d_act(x, _randn(gen, 2, 2, 16, 16), None, k=2, stride=2)
    with pytest.raises(ValueError, match="channel slice"):
        tcv.conv2d_act(x.transpose(1, 2), wt, None)
    before = tcv.conv2d_act.launches
    tcv.conv2d_act(x, _randn(gen, 1, 1, 16, 16), None, k=1)  # a matmul: no launch
    assert tcv.conv2d_act.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("cm", [48, 50, 128])
def test_pack_and_fetch_vs_bool_crops(gen, cm):
    """The device bitpack is ``np.packbits`` along the last axis, and a batch
    fetched through a pinned slot (``_start_fetch`` then ``_fetch_outputs``,
    which waits on the slot's event) unpacks to the bool crops."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    pipe = tengine.CellSegmentationPipeline(device="cuda", sam_config=sam_tiny_test())
    crops = (torch.rand(32, 16, cm, cm, generator=gen) > 0.5).cuda()
    want = crops.cpu().numpy()
    assert (tengine.pack_bits(crops).cpu().numpy() == np.packbits(want, axis=-1)).all()
    zeros = torch.zeros(32, 16, device="cuda")
    outputs = (torch.zeros(32, 16, 4, device="cuda"), zeros, zeros > 0, crops,
               torch.zeros(32, 16, 2, dtype=torch.long, device="cuda"),
               {key: zeros + i for i, key in enumerate(METRIC_KEYS)})
    rank = {key: i for i, key in enumerate(METRIC_KEYS)}
    for _ in range(4):  # every slot of the ring, each reused once
        h = pipe._start_fetch(pipe._acquire_slot(), outputs, fetch_masks=True)
        assert h["csv"].is_pinned() and h["packed"].is_pinned()
        out = pipe._fetch_outputs(h)
        assert np.array_equal(out["mask_crops"], want)
        assert all((out["metrics"][key] == rank[key]).all() for key in METRIC_KEYS)


@pytest.mark.cuda
def test_process_directory_vs_process_batch_arrays(gen, tmp_path):
    """Config 1 on the card, 6 PNG frames at batch 2: the overlapped
    directory path's rows equal the synced stage API on the same batches."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    frames = cell_frames(np.random.default_rng(3), 6, 512)[..., 0]
    for i, frame in enumerate(frames):
        write_png(tmp_path / f"f_{i}.png", frame)
    pipe = tengine.CellSegmentationPipeline(
        device="cuda", options=tengine.PipelineOptions(batch_size=2, max_det=16))
    batch = pipe.process_directory(tmp_path, tmp_path / "out", progress=False)
    stats = pipe.last_directory_stats
    assert (stats["n_images"], stats["n_batches"], stats["n_sample_batches"]) == (6, 3, 1)
    by_name = {r.image_path.rsplit("/", 1)[-1]: r for r in batch.results}
    for b0 in range(0, 6, 2):
        out = pipe.process_batch_arrays(frames[b0:b0 + 2])
        for j in range(2):
            res = by_name[f"f_{b0 + j}.png"]
            kept = np.flatnonzero(out["valid"][j])
            assert res.num_cells == len(kept)
            for row, k in zip(res.cell_metrics, kept):
                for key, got in row.items():
                    want = float(out["metrics"][key][j, k])
                    want = float(np.round(want)) if key in INT_METRIC_KEYS else want
                    assert abs(got - want) <= 1e-5 + 1e-5 * abs(want), (key, got, want)
    assert sum(r.num_cells for r in batch.results) > 0
