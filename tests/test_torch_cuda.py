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

import numpy as np
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
from yolo_sam_inference_tpu_torch.ops.hull_support import (
    hull_candidates,
    hull_support,
    hull_support_plain,
)
from yolo_sam_inference_tpu_torch.ops.metrics import calculate_metrics
from yolo_sam_inference_tpu_torch.ops import preprocess as tpre
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
    combines = dec.t2i_combine.launches
    part = torch.zeros(2, 2, 8 * 8 * 18, device="cuda")  # laid out for at most 8 next queries
    with pytest.raises(ValueError, match="partials hold"):  # read at 9: past its end
        dec.t2i_combine(part, 9)
    with pytest.raises(ValueError, match="contiguous fp32"):
        dec.t2i_combine(part.to(torch.bfloat16), 8)
    assert dec.t2i_combine.launches == combines


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
    (False, 1, 196, 7, 7), (False, 1, 4096, 7, 7),
    (True, 4, 196, 5, 17), (True, 1, 256, 34, 9), (True, 2, 4096, 16, 3)])
def test_keys_stream_vs_plain(gen, i2t, k_share, t, tq, tq2):
    """keys_stream: the i2t pass with the next attention split over its
    128-token tiles and joined by t2i_combine (K7), or the k/v projection pass
    (K6). T 196 and 784: a short last tile; 4096: 32 tiles; k_share 16:
    layer 0's prompts sharing their image's keys; tq and tq2 up to 8 (the
    kernel's staged form) or past it apart (its grouped form)."""
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
@pytest.mark.parametrize("tq", [7, 9, 16, 17, 34])
def test_decoder_kernels_at_any_prompt_count(gen, tq):
    """K6 and K7 at tq prompt tokens (= tq next queries), on a grid of 28
    (a short last tile): 7 a box prompt's; 9, 16, 17 and 34 a point prompt's
    (past one group of 8, a whole group of 16, two groups; 28 points). Layer
    0's pass (16 prompts sharing an image's keys) and layer 1's, each with
    t2i_combine, the k/v pass and t2i_attend (16 x 34 = 544 rows an image:
    two blocks), each against its fp32 plain version, every call a launch."""
    nsrc, k_share, t = 2, 16, 784
    n = nsrc * k_share
    p = _decoder_weights(gen)
    img, pe, keys = _randn(gen, nsrc, t, 256), _randn(gen, t, 256), _randn(gen, n, t, 256)
    kq, vq = _randn(gen, n, tq, 128), _randn(gen, n, tq, 128)
    qn = _randn(gen, n, tq, 128, std=0.25)
    w = (p["wq"], p["bq"], p["wout"], p["bout"], p["ln_s"], p["ln_b"])
    nxt = {"wk": p["wk"], "bk": p["bk"], "wv": p["wv"], "bv": p["bv"]}
    before = dec.keys_stream.launches, dec.t2i_combine.launches, dec.t2i_attend.launches
    for src, share in ((img, k_share), (keys, 1)):
        got = dec.i2t_keys_update(src, pe, kq, vq, *w, heads=8, k_share=share,
                                  t2i={"qp": qn, **nxt})
        want = dec.i2t_keys_update_plain(src.float(), pe.float(), kq.float(), vq.float(), *w,
                                         heads=8, k_share=share, t2i={"qp": qn.float(), **nxt})
        for g_, w_ in zip(got, want):
            _close(g_, w_, 2e-2)
    kp, vp = dec.kv_project(img, pe, p["wk"], p["bk"], p["wv"], p["bv"], 8)
    _close(dec.t2i_attend(qn, kp, vp, 8, k_share),
           dec.t2i_attend_plain(qn.float(), kp.float(), vp.float(), 8, k_share), 2e-2)
    assert (dec.keys_stream.launches, dec.t2i_combine.launches, dec.t2i_attend.launches) == (
        before[0] + 3, before[1] + 2, before[2] + 1)
    with pytest.raises(ValueError, match="at least 1 prompt token"):  # refused only below 1
        dec.t2i_attend(qn[:, :0], kp, vp, 8, k_share)


def _prompt_models():
    """ViT-B's widths at the 512 canvas with 2 encoder layers: the model in
    bf16 on the card, and the same bf16-rounded weights in fp32 (the plain
    oracle)."""
    import dataclasses

    from yolo_sam_inference_tpu_torch.models.sam import init_sam_params, sam_vit_b
    from yolo_sam_inference_tpu_torch.pipeline.engine import _round_floating
    from yolo_sam_inference_tpu_torch.weights import from_jax_params

    cfg = dataclasses.replace(sam_vit_b(512), vision_layers=2, global_attn_indexes=(1,))
    tree = init_sam_params(0, cfg)
    _, sam = from_jax_params(None, tree, "cuda", torch.bfloat16, sam_config=cfg)
    _, ref = from_jax_params(None, _round_floating(tree, torch.bfloat16), "cuda", torch.float32,
                             sam_config=cfg)
    return cfg, sam, ref


def _rel_rms(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.cuda
def test_sam_prompt_api_through_the_kernels(gen):
    """``SamModel`` on the card in bf16: ``forward_boxes`` with
    ``multimask_output`` (3 masks a box) and the decoder on 10-point prompts
    with a dense prompt (tq 16), each through K6 and K7 (1 + 1 and 2 + 2
    launches a call, as for boxes) and within the decoder's 5% relative RMS
    of the fp32 plain model on the same bf16-rounded weights."""
    import numpy as np

    cfg, sam, ref = _prompt_models()
    rng = np.random.default_rng(0)
    b, k, gs = 2, 4, cfg.grid_size
    pix = torch.from_numpy(rng.normal(size=(b, 512, 512, 3)).astype(np.float32)).cuda()
    xy = rng.uniform(0, 400, size=(b, k, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(16, 100, size=(b, k, 2))],
                                            -1).astype(np.float32)).cuda()
    counts = lambda: (dec.keys_stream.launches, dec.t2i_combine.launches,
                      dec.t2i_attend.launches)
    with torch.inference_mode():
        before = counts()
        masks, iou = sam.forward_boxes(pix.bfloat16(), boxes, multimask_output=True)
        assert counts() == (before[0] + 3, before[1] + 2, before[2] + 1)
        rmasks, riou = ref.forward_boxes(pix, boxes, multimask_output=True, plain=True)
        assert tuple(masks.shape) == (b, k, 3, 4 * gs, 4 * gs) and tuple(iou.shape) == (b, k, 3)
        assert _rel_rms(masks, rmasks) < 0.05 and _rel_rms(iou, riou) < 0.05
        emb = ref.vision(pix, plain=True)
        pts = torch.from_numpy(rng.uniform(0, 512, size=(b, k, 10, 2)).astype(np.float32)).cuda()
        labels = torch.from_numpy(rng.integers(0, 2, size=(b, k, 10)).astype(np.int32)).cuda()
        dense = torch.from_numpy((0.1 * rng.normal(size=(b, gs, gs, 256))).astype(np.float32))
        dense = dense.cuda()
        before = counts()
        sparse = sam.prompt.points(pts, labels).bfloat16()
        masks, iou = sam.mask_decoder(emb.bfloat16(), sparse, dense.bfloat16())
        assert counts() == (before[0] + 3, before[1] + 2, before[2] + 1)
        rmasks, riou = ref.mask_decoder(emb, ref.prompt.points(pts, labels), dense, plain=True)
        assert tuple(masks.shape) == (b, k, 1, 4 * gs, 4 * gs)
        assert _rel_rms(masks, rmasks) < 0.05 and _rel_rms(iou, riou) < 0.05


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
@pytest.mark.parametrize("n,gs,wg,c", [
    (512, 32, 11, 256),   # config 1
    (512, 64, 7, 256),    # config 4
    (37, 64, 35, 256),    # a wide window
    (5, 16, 16, 64),      # the whole grid, narrow C
    (3, 14, 9, 8)])
def test_window_crop_reads_the_engines_starts(gen, n, gs, wg, c):
    """The kernel reads the starts in place: the two columns of one (N, 2)
    tensor (strided views), some outside [0, gs - wg]; one launch, nothing
    else on the stream (no cast), and a copy of its plain version."""
    grid = _randn(gen, n, gs, gs, c)
    starts = torch.randint(-3, gs - wg + 4, (n, 2), generator=gen).cuda()
    before = window_crop.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = window_crop(grid, starts[:, 0], starts[:, 1], wg)
        torch.cuda.synchronize()
    assert window_crop.launches == before + 1
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert all("window_crop" in name for name in names), names
    assert torch.equal(got, window_crop_plain(grid, starts[:, 0], starts[:, 1], wg))


@pytest.mark.cuda
def test_window_crop_refuses_what_the_kernel_does_not_take(gen):
    grid = _randn(gen, 4, 16, 16, 256)
    starts = torch.zeros(4, 2, dtype=torch.int64, device="cuda")
    for bad in (starts.float(), starts.int(), starts.cpu(), starts[:3]):
        with pytest.raises(ValueError):
            window_crop(grid, bad[:, 0], bad[:, 1], 8)
    with pytest.raises(ValueError):  # c0 of another type than r0
        window_crop(grid, starts[:, 0], starts[:, 1].int(), 8)
    with pytest.raises(ValueError):  # C no multiple of 8
        window_crop(_randn(gen, 4, 16, 16, 36), starts[:, 0], starts[:, 1], 8)


def _hull_case(case: str, h: int, w: int) -> torch.Tensor:
    """A (h, w) bool mask on the card: empty, one pixel, full, an ellipse
    touching all four edges, or a random blob (three ellipses, some off the
    mask)."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device="cuda"),
                            torch.arange(w, dtype=torch.float64, device="cuda"), indexing="ij")
    m = torch.zeros(h, w, dtype=torch.bool, device="cuda")
    if case == "one pixel":
        m[h // 3, w // 2] = True
    elif case == "full":
        m[:] = True
    elif case == "four edges":
        m = ((yy - (h - 1) / 2) / (h / 2)) ** 2 + ((xx - (w - 1) / 2) / (w / 2)) ** 2 <= 1.0
    elif case == "blob":
        g = torch.Generator().manual_seed(h * w)
        for _ in range(3):
            cy, cx = ((torch.rand(2, generator=g, dtype=torch.float64) * 0.8 + 0.1)
                      * torch.tensor([h, w])).tolist()
            ry, rx = ((torch.rand(2, generator=g, dtype=torch.float64) * 0.35 + 0.05)
                      * torch.tensor([h, w])).tolist()
            m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    return m


def _dirs(d: int) -> torch.Tensor:
    ang = torch.arange(d, dtype=torch.float64) * (2 * torch.pi / d)
    return torch.stack([ang.cos(), ang.sin()], 1).float().cuda()


@pytest.mark.cuda
def test_support_points_vs_plain(gen):
    """K9 from the masks at config 1's shape: 512 ellipse crops of 128 x 128
    (some touching the edges, a few empty), 256 directions: the same rounded
    fp32 scores and the same tie-break, so identical points and flags; one
    launch and no plain front end."""
    yy, xx = torch.meshgrid(torch.arange(128.0), torch.arange(128.0), indexing="ij")
    c = torch.rand(512, 2, 1, 1, generator=gen) * 88 + 20
    ax = torch.rand(512, 2, 1, 1, generator=gen) * 40 + 2
    masks = (((yy - c[:, 0]) / ax[:, 0]) ** 2 + ((xx - c[:, 1]) / ax[:, 1]) ** 2 <= 1.0)
    masks[::97] = False
    masks, dirs = masks.cuda(), _dirs(256)
    before, fronts = hull_support.launches, hull_candidates.calls
    got, got_any = hull_support(masks, dirs)
    assert hull_support.launches == before + 1 and hull_candidates.calls == fronts
    want, want_any = hull_support_plain(masks, dirs)
    assert torch.equal(got, want) and torch.equal(got_any, want_any)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(64, 64), (128, 128), (256, 256), (99, 101), (37, 256),
                                 (300, 258), (2048, 2048), (2049, 2049), (2048, 3000),
                                 (3000, 2048), (4096, 4096), (48, 5000), (8192, 8192), (1, 40000),
                                 (40000, 3)])
@pytest.mark.parametrize("case", ["empty", "one pixel", "full", "four edges", "blob"])
def test_hull_support_edge_cases_vs_plain(gen, case, h, w):
    """K9's edge cases at crops of 64, 128 and 256 (the crops' kernel),
    sides that are no multiple of 16 or 4 (byte loads, the byte pass), a
    flat crop, and the frames' kernels: masks of several tiles (300 x 258:
    word and byte tiles), whole frames from 2048 x 2048 to 8192 x 8192,
    sides past 2048 and 4096 (the old key's limits), a 48-row frame, a row
    and a 3-column strip of 40000, with a direction count that is no
    multiple of 32: equal to the plain version."""
    masks = torch.stack([_hull_case(case, h, w), _hull_case("blob", h, w)])
    for d in (256, 100):
        got, got_any = hull_support(masks, _dirs(d))
        want, want_any = hull_support_plain(masks, _dirs(d))
        assert torch.equal(got, want) and torch.equal(got_any, want_any), (case, d)


@pytest.mark.cuda
def test_hull_support_refuses_what_the_kernel_does_not_take(gen):
    dirs = _dirs(256)
    for bad in (torch.zeros(2, 64, 64, device="cuda"),
                torch.zeros(2, 64, 128, dtype=torch.bool, device="cuda")[:, :, ::2]):
        with pytest.raises(ValueError):
            hull_support(bad, dirs)
    with pytest.raises(ValueError):
        hull_support(torch.zeros(2, 64, 64, dtype=torch.bool, device="cuda"), dirs.double())
    with pytest.raises(ValueError):  # no direction: nothing to select
        hull_support(torch.ones(2, 64, 64, dtype=torch.bool, device="cuda"), dirs[:0])
    pts, flags = hull_support(torch.zeros(0, 64, 64, dtype=torch.bool, device="cuda"), dirs)
    assert pts.shape == (0, 256, 2) and flags.shape == (0,)


def _frame(h: int, w: int, seed: int):
    """A uniform random RGB (h, w, 3) uint8 image and the centred ellipse
    with semi-axes 0.45 h and 0.45 w (as ``tests/test_torch_metrics.py``
    draws its whole frames)."""
    image = np.random.default_rng(seed).integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return image, ((yy - h / 2) / (0.45 * h)) ** 2 + ((xx - w / 2) / (0.45 * w)) ** 2 <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("hull_mode", ["polygon", "reference"])
@pytest.mark.parametrize("h,w", [(2100, 2300), (48, 2048)])
def test_calculate_metrics_on_the_card_whole_frames(gen, h, w, hull_mode):
    """The single-cell API on whole frames on the card (K9's frames'
    kernels, the exact moment sums): equal to its CPU run, integers exactly,
    floats within 1e-5 relative or absolute (fp32 sums in another order); the brightness
    within 1e-4 of the float64 oracle (the reference's disk around the exact
    centroid); one K9 launch. Deformability is 1 - circularity, about
    0.04 here, so it also takes circularity's 1e-5 as an absolute bound."""
    image, mask = _frame(h, w, h + w)
    before = hull_support.launches
    got = calculate_metrics(image, mask, hull_mode, device="cuda")
    assert hull_support.launches == before + 1
    want = calculate_metrics(image, mask, hull_mode, device="cpu")
    for key, v in want.items():
        assert type(got[key]) is type(v), key
        assert got[key] == v if isinstance(v, int) else \
            got[key] == pytest.approx(v, rel=1e-5, abs=1e-5), (key, got[key], v)
    rows, cols = np.nonzero(mask)
    yy, xx = np.mgrid[:h, :w]
    disk = (yy - rows.mean()) ** 2 + (xx - cols.mean()) ** 2 <= int(0.1 * min(h, w)) ** 2
    gray = image.astype(np.float64).mean(axis=2)[disk]
    assert got["mean_brightness"] == pytest.approx(gray.mean(), rel=1e-4)
    assert got["brightness_std"] == pytest.approx(gray.std(), rel=1e-4)


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
    ((2, 16, 16, 256), 512, 3, 2, "silu", True, False),   # YOLOv8s down5: Co 512
    ((2, 8, 8, 256), 256, 3, 1, "silu", True, True),      # v8s c2f5's bottleneck, a slice
    ((2, 8, 8, 512), 64, 3, 1, "silu", True, False),      # v8s detect box1 at level 2: Ci 512
    ((2, 8, 8, 512), 128, 3, 1, "silu", True, False),     # v8s detect cls1 at level 2
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
def test_rasterized_hull_on_the_card_equals_the_cpu(gen):
    """``hull_mode="reference"``: on a CUDA tensor the support vertices come
    from K9's kernel, and the rasterised hull's measures equal the CPU plain
    path's (areas exact, perimeters to fp32 summation order)."""
    from yolo_sam_inference_tpu_torch.ops.metrics import rasterized_hull_measures

    yy, xx = torch.meshgrid(torch.arange(128.0), torch.arange(128.0), indexing="ij")
    c = torch.rand(64, 2, 1, 1, generator=gen) * 60 + 34  # centres, edges and corners too
    c[:8] = torch.rand(8, 2, 1, 1, generator=gen) * 8
    ax = torch.rand(64, 2, 1, 1, generator=gen) * 28 + 6
    masks = ((yy - c[:, 0]) / ax[:, 0]) ** 2 + ((xx - c[:, 1]) / ax[:, 1]) ** 2 <= 1.0
    masks[-1] = False
    before = hull_support.launches
    area, perim = rasterized_hull_measures(masks.cuda())
    assert hull_support.launches == before + 1
    want_a, want_p = rasterized_hull_measures(masks)
    assert torch.equal(area.cpu(), want_a) and want_a[-1] == 0 and (want_a[:-1] > 0).all()
    torch.testing.assert_close(perim.cpu(), want_p, rtol=1e-5, atol=0)


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


def _rows_equal(rows, out, j, where):
    """Metric rows (a response's cells or CSV rows) against image ``j`` of
    ``process_batch_arrays`` outputs: ints exact, floats within 1e-5."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.ops.metrics import INT_METRIC_KEYS, METRIC_KEYS

    kept = np.flatnonzero(out["valid"][j])
    assert len(rows) == len(kept), where
    for row, k in zip(rows, kept):
        for key in METRIC_KEYS:
            got, want = float(row[key]), float(out["metrics"][key][j, k])
            want = float(np.round(want)) if key in INT_METRIC_KEYS else want
            assert abs(got - want) <= 1e-5 + 1e-5 * abs(want), (where, key, got, want)


@pytest.mark.cuda
def test_service_on_the_card_without_pil(gen, monkeypatch):
    """Config 1 behind the service on the card, batch 2, PIL hidden: PNG
    bodies of mode-L frames decode without it, and each response's cells
    equal ``process_batch_arrays`` on the same two frames."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.io import images as timages
    from yolo_sam_inference_tpu_torch.io.png import png_bytes
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.web import serve as tserve

    monkeypatch.setattr(timages, "_PILImage", None)
    frames = cell_frames(np.random.default_rng(4), 2, 512)[..., 0]
    pipe = tengine.CellSegmentationPipeline(
        device="cuda", options=tengine.PipelineOptions(batch_size=2, max_det=16))
    ref = pipe.process_batch_arrays(frames)
    server, service = tserve.serve(pipe, port=0, image_shape=(512, 512))
    loop = threading.Thread(target=server.serve_forever, daemon=True)
    loop.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/segment"
        for j in range(2):
            req = urllib.request.Request(url, data=png_bytes(frames[j], 4), method="POST",
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=120) as r:
                resp = json.loads(r.read())
            _rows_equal(resp["cells"], ref, j, f"frame {j}")
        assert service.stats["requests"] == 2 and service.stats["errors"] == 0
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    assert int(ref["valid"].sum()) > 0


@pytest.mark.cuda
def test_project_runner_on_the_card(gen, tmp_path):
    """The project runner on a two-condition tree of mode-L PNG frames (one
    batch of 2 a condition): each condition's rows equal
    ``process_batch_arrays`` on its frames, and the gated file is the ROI
    gate of the combined rows."""
    import csv

    import numpy as np

    from yolo_sam_inference_tpu_torch.apps import project_inference as tapp
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.gate.filter import filter_cells_by_roi
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    frames = cell_frames(np.random.default_rng(5), 4, 512)[..., 0]
    for c, cond in enumerate(("a", "b")):
        (tmp_path / "p" / cond / "batch_1").mkdir(parents=True)
        for i in range(2):
            write_png(tmp_path / "p" / cond / "batch_1" / f"f_{i}.png", frames[2 * c + i])
    assert tapp.main(["--project-dir", str(tmp_path / "p"), "--output-dir",
                      str(tmp_path / "out"), "--roi", "100,400", "--batch-size", "1",
                      "--max-det", "16"]) == 0
    (run_dir,) = (tmp_path / "out").iterdir()
    pipe = tengine.CellSegmentationPipeline(
        device="cuda", options=tengine.PipelineOptions(batch_size=2, max_det=16))

    def read(path):
        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    for c, cond in enumerate(("a", "b")):
        out = pipe.process_batch_arrays(frames[2 * c:2 * c + 2])
        rows = read(run_dir / cond / run_dir.name / "cell_metrics.csv")
        for j in range(2):
            _rows_equal([r for r in rows if r["image_name"] == f"f_{j}.png"], out, j, cond)
    combined = read(run_dir / "cell_metrics.csv")
    numeric = [{**r, "min_y": float(r["min_y"]), "max_y": float(r["max_y"])} for r in combined]
    kept = filter_cells_by_roi(numeric, {c: {"x_min": 100, "x_max": 400} for c in ("a", "b")})
    assert read(run_dir / "gated_cell_metrics.csv") == [combined[numeric.index(r)] for r in kept]


def _classical_frames(gen, n, size):
    """uint8 frames near 30 with filled ellipses of 200, and the background."""
    yy, xx = torch.meshgrid(torch.arange(float(size)), torch.arange(float(size)), indexing="ij")
    bg = (torch.randn(size, size, generator=gen) + 30).clamp(0, 255).to(torch.uint8)
    frames = bg.repeat(n, 1, 1)
    for i in range(n):
        for _ in range(5):
            c = torch.rand(2, generator=gen) * (size - 48) + 24
            ax = torch.rand(2, generator=gen) * 12 + 6
            frames[i][((yy - c[0]) / ax[0]) ** 2 + ((xx - c[1]) / ax[1]) ** 2 <= 1.0] = 200
    return frames, bg


@pytest.mark.cuda
def test_morphology_on_the_card_equals_the_cpu(gen):
    """Every function of ``ops/morphology.py`` on a CUDA tensor against the
    CPU port: masks equal, blur and contrast within 1e-5."""
    from yolo_sam_inference_tpu_torch.ops import morphology as tm

    frames, bg = _classical_frames(gen, 8, 256)
    for dev_frames, dev_bg, out in ((frames.cuda(), bg.cuda(), {}), (frames, bg, {})):
        f = dev_frames.float()
        bgb = tm.gaussian_blur(dev_bg.float(), 5, 0.0)
        out["blur"] = tm.gaussian_blur(f, 7, 1.2)
        out["contrast"] = tm.contrast(f, 1.2, -3.0)
        out["sub"] = tm.subtract_clip(out["contrast"], bgb[None])
        m = tm.threshold_binary(tm.absdiff(f, bgb[None]), 10.0)
        for it in (1, 2, 3):
            for name in ("dilate", "erode", "morph_open", "morph_close"):
                out[f"{name}{it}"] = getattr(tm, name)(m, 3, it)
        out["detect"] = tm.classical_detect_batch(dev_frames, bgb, threshold=10.0)
        if dev_frames.is_cuda:
            card = {k: v.cpu() for k, v in out.items()}
        else:
            cpu = out
    for key, want in cpu.items():
        if want.dtype == torch.bool:
            assert torch.equal(card[key], want), key
        else:
            assert (card[key] - want).abs().max().item() <= 1e-5, key


@pytest.mark.cuda
def test_classical_pipeline_on_the_card_equals_the_cpu(gen):
    """``ClassicalPipeline`` on the card: the rows of the CPU port's (ints
    exact, floats 1e-5) and K9 once for the batch."""
    from yolo_sam_inference_tpu_torch.classical.pipeline import ClassicalParams, ClassicalPipeline

    frames, bg = _classical_frames(gen, 8, 256)
    params = ClassicalParams(threshold=10.0, min_area=30)
    card = ClassicalPipeline(params)
    card.preprocess_background(bg.numpy())
    before = hull_support.launches
    got = card.process_images(frames.numpy(), return_masks=True)
    assert hull_support.launches == before + 1
    want = ClassicalPipeline(params, device="cpu").process_images(
        frames.numpy(), background=bg.numpy(), return_masks=True)
    import numpy as np

    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    assert sum(map(len, want[0])) > 8
    for g_rows, w_rows in zip(got[0], want[0]):
        assert len(g_rows) == len(w_rows)
        for g, w in zip(g_rows, w_rows):
            for k, v in w.items():
                assert abs(g[k] - v) <= 1e-6 + 1e-5 * abs(v), k


@pytest.mark.cuda
def test_stream_runner_on_the_card_equals_the_cpu(gen, tmp_path):
    """``apps/ms_opencv_process.py`` on the card and with ``--device cpu``:
    ``deformability_results.csv`` byte-equal, no kernel launched."""
    from yolo_sam_inference_tpu_torch.apps import ms_opencv_process as tstream
    from yolo_sam_inference_tpu_torch.bench.common import write_png
    from yolo_sam_inference_tpu_torch.io.images_bin import write_images_bin

    size = 128
    yy, xx = torch.meshgrid(torch.arange(float(size)), torch.arange(float(size)), indexing="ij")
    bg = (torch.randn(size, size, generator=gen) + 30).clamp(0, 255).to(torch.uint8)
    frames = []
    for i in range(96):
        f = bg.clone()
        c = torch.rand(2, generator=gen) * 40 + 44
        d2 = (yy - c[0]) ** 2 + (xx - c[1]) ** 2
        f[(d2 <= 17 ** 2) & (d2 >= 12 ** 2)] = 220
        frames.append(f.numpy())
    batch = tmp_path / "proj" / "batch_1"
    batch.mkdir(parents=True)
    write_images_bin(batch / "images.bin", frames)
    write_png(batch / "background.png", bg.numpy())
    argv = ["--project-dir", str(tmp_path / "proj"), "--batch-size", "32"]
    assert tstream.main(argv + ["--output-dir", str(tmp_path / "card")]) == 0
    assert tstream.main(argv + ["--output-dir", str(tmp_path / "cpu"), "--device", "cpu"]) == 0
    got = (tmp_path / "card" / "deformability_results.csv").read_bytes()
    assert got == (tmp_path / "cpu" / "deformability_results.csv").read_bytes()
    assert got.count(b"\n") > 48


@pytest.mark.cuda
def test_process_pending_on_the_card(gen, tmp_path):
    """``registry/nodes.process_pending`` on the card: each stored row equals
    ``process_batch_arrays`` of its frame alone (boxes, confidence, the 9
    stored metrics within 1e-5, the full-frame mask exact); the unreadable
    file is an error row; a second pass processes nothing."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine
    from yolo_sam_inference_tpu_torch.registry import WorkManifest
    from yolo_sam_inference_tpu_torch.registry.manifest import metrics_to_result_row
    from yolo_sam_inference_tpu_torch.registry.nodes import process_pending
    from yolo_sam_inference_tpu_torch.utils.mask_encoding import decode_binary_mask

    frames = cell_frames(np.random.default_rng(8), 3, 512)[..., 0]
    paths = []
    for i, frame in enumerate(frames):
        write_png(tmp_path / f"f_{i}.png", frame)
        paths.append(str(tmp_path / f"f_{i}.png"))
    (tmp_path / "bad.png").write_bytes(b"not an image")
    m = WorkManifest(tmp_path / "m.db")
    m.ingest(paths + [str(tmp_path / "bad.png")])
    pipe = tengine.CellSegmentationPipeline(
        device="cuda", options=tengine.PipelineOptions(batch_size=1, max_det=16))
    stats = process_pending(m, pipe)
    assert (stats["processed"], stats["errors"]) == (3, 1)
    cells = 0
    for i, path in enumerate(paths):
        out = pipe.process_batch_arrays(frames[i:i + 1])
        rows = m.get_results(path)
        kept = np.flatnonzero(out["valid"][0])
        assert len(rows) == len(kept)
        for row, k in zip(rows, kept):
            want = metrics_to_result_row(pipe._metrics_row(out["metrics"], 0, k),
                                         box=out["boxes"][0, k], confidence=out["scores"][0, k])
            for key, value in want.items():
                if key == "box":
                    for b, v in value.items():
                        assert row[key][b] == pytest.approx(v, rel=1e-5, abs=1e-5), b
                else:
                    assert row[key] == pytest.approx(value, rel=1e-5, abs=1e-5), key
            full = np.zeros((512, 512), bool)
            r0, c0 = out["offsets"][0, k]
            full[r0:r0 + 128, c0:c0 + 128] = out["mask_crops"][0, k]
            assert np.array_equal(decode_binary_mask(row["mask"]), full)
            cells += 1
    assert cells > 0
    assert process_pending(m, pipe)["processed"] == 0
    assert [r["minio_path"] for r in m.list_rows() if r["error"]] == [str(tmp_path / "bad.png")]


@pytest.mark.cuda
def test_data_parallel_on_the_card(gen, tmp_path):
    """``mesh=make_mesh(dp=2)`` on 2 ranks sharing the card (gloo): every
    rank returns the whole batch, equal to the single card on the same
    frames in the ranks' batches (4 frames: 2 a rank; 3: 2 and 1 + the
    padding), and ``process_directory`` under the mesh gives the single
    card's rows at the share's batch."""
    import json

    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames, write_png
    from yolo_sam_inference_tpu_torch.ops.metrics import METRIC_KEYS
    from yolo_sam_inference_tpu_torch.parallel.launch import run_ranks
    from yolo_sam_inference_tpu_torch.parallel.workers import run_jobs
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    frames = cell_frames(np.random.default_rng(9), 4, 256)[..., 0]
    np.save(tmp_path / "f4.npy", frames)
    np.save(tmp_path / "f3.npy", frames[:3])
    (tmp_path / "in").mkdir()
    for i in range(6):
        write_png(tmp_path / "in" / f"f_{i}.png", frames[i % 4])
    kwargs = dict(device="cuda", seed=0, options=tengine.PipelineOptions(batch_size=4,
                                                                         max_det=16))
    job = {"kind": "dp", "mesh": {"dp": 2}, "kwargs": kwargs,
           "frames": [str(tmp_path / "f4.npy"), str(tmp_path / "f3.npy")],
           "dir": str(tmp_path / "in"), "outdir": str(tmp_path / "out"),
           "out": str(tmp_path / "dp")}
    assert run_ranks(run_jobs, 2, ([job],)) == "gloo"
    single = tengine.CellSegmentationPipeline(**{**kwargs, "options": tengine.PipelineOptions(
        batch_size=2, max_det=16)})
    for i, n in enumerate((4, 3)):
        padded = np.concatenate([frames[:n], np.zeros((4 - n, 256, 256), np.uint8)])
        parts = [single.process_batch_arrays(padded[s:s + 2]) for s in (0, 2)]
        for r in range(2):
            with np.load(tmp_path / f"dp.rank{r}.npz") as got:
                for key in ("valid", "offsets", "mask_crops"):
                    want = np.concatenate([p[key] for p in parts])[:n]
                    np.testing.assert_array_equal(got[f"{i}/{key}"], want, err_msg=key)
                for key in ("boxes", "scores"):
                    want = np.concatenate([p[key] for p in parts])[:n]
                    np.testing.assert_allclose(got[f"{i}/{key}"], want, rtol=1e-5, atol=1e-5)
                for key in METRIC_KEYS:
                    want = np.concatenate([p["metrics"][key] for p in parts])[:n]
                    np.testing.assert_allclose(got[f"{i}/metric_{key}"], want, rtol=1e-5,
                                               atol=1e-5, err_msg=key)
    ref = single.process_directory(tmp_path / "in", tmp_path / "single", progress=False)
    for r in range(2):
        with open(tmp_path / f"dp.rank{r}.json") as f:
            info = json.load(f)
        assert info["writes"] == (r == 0)
        assert len(info["rows"]) == len(ref.results) == 6
        for (_, got), want in zip(info["rows"], ref.results):
            assert len(got) == want.num_cells
            for g, w in zip(got, want.cell_metrics):
                for key in METRIC_KEYS:
                    assert g[key] == pytest.approx(w[key], rel=1e-5, abs=1e-5), key


def _grad_cases(gen):
    """The kernels the fine-tune step's forward reaches, at shapes they take:
    (entry, plain version, args, kwargs, (counter, its attribute)), bf16
    tensors that require a gradient."""
    def r(*shape, std=1.0):
        return _randn(gen, *shape, std=std).requires_grad_()

    c, heads, hd = 768, 12, 64
    qkv = r(1, 32, 32, 3 * c)
    flat = qkv.reshape(1, 1024, 3 * c)
    keys, pe = r(2, 1024, 256), r(1024, 256)
    t2i = {"qp": r(8, 7, 128, std=0.1), "wk": r(256, 128, std=0.06), "bk": r(128),
           "wv": r(256, 128, std=0.06), "bv": r(128)}
    return {
        "gemm_bf16": (tln.gemm_bf16, tln.gemm_plain, (r(512, 768), r(768, 256, std=0.04), r(256)),
                      dict(a2=r(512, 768), ln=(r(768), r(768), 1e-6), gelu=True, r1=r(512, 256)),
                      (tln.gemm_bf16, "launches")),
        "layer_norm": (tln.layer_norm, tln.layer_norm_plain, (r(64, 256), r(256), r(256), 1e-6),
                       dict(residual=r(64, 256)), (tln.layer_norm, "residual_launches")),
        "window_attention": (window_attention, window_attention_plain,
                             (qkv, r(31, hd, std=0.3), r(31, hd, std=0.3), heads, 16), {},
                             (window_attention, "launches")),
        "flash_attention_relpos": (flash_attention_relpos, relpos_attention_plain,
                                   (flat[..., :c], flat[..., c:2 * c], flat[..., 2 * c:],
                                    r(63, hd, std=0.3), r(63, hd, std=0.3), 32), {},
                                   (flash_attention_relpos, "launches")),
        "t2i_shared_attend": (dec.t2i_shared_attend, dec.t2i_shared_attend_plain,
                              (keys, pe, r(8, 7, 128, std=0.1), r(256, 128, std=0.06), r(128),
                               r(256, 128, std=0.06), r(128), 8, 4), {},
                              (dec.t2i_attend, "launches")),
        "i2t_keys_update": (dec.i2t_keys_update, dec.i2t_keys_update_plain,
                            (keys, pe, r(8, 7, 128, std=0.3), r(8, 7, 128), r(256, 128, std=0.06),
                             r(128), r(128, 256, std=0.09), r(256), r(256), r(256)),
                            dict(heads=8, k_share=4, eps=1e-6, t2i=t2i),
                            (dec.keys_stream, "launches")),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemm_bf16", "layer_norm", "window_attention",
                                  "flash_attention_relpos", "t2i_shared_attend",
                                  "i2t_keys_update"])
def test_kernel_gradients_on_the_card(gen, name):
    """``ops/autograd.py`` on the card: a kernel entry recorded by autograd
    launches its kernel once (counted), returns outputs with a ``grad_fn``
    within the kernel's bound of the plain version, and its backward (the
    plain version's autograd in fp32) gives gradients within 1% of fp32 plain
    autograd on the same bf16 inputs, cast up (cosine 0.9999), for every
    input whose gradient is not zero by construction (a key bias, which the
    softmax drops: its gradient is rounding noise, below 1e-4 of the
    largest)."""
    fn, plain, args, kwargs, (counter, attr) = _grad_cases(gen)[name]
    leaves = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor) and t.requires_grad]
    before = getattr(counter, attr)
    out = fn(*args, **kwargs)
    assert getattr(counter, attr) == before + 1
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.grad_fn is not None for o in outs)
    g = torch.Generator().manual_seed(3)
    weights = [torch.randn(o.shape, generator=g).cuda() for o in outs]
    got = torch.autograd.grad(sum((o.float() * w).sum() for o, w in zip(outs, weights)), leaves)
    up = [t.detach().float().requires_grad_() for t in leaves]
    swap = dict(zip(map(id, leaves), up))
    a32, k32 = torch.utils._pytree.tree_map(
        lambda t: swap.get(id(t), t) if isinstance(t, torch.Tensor) else t, (args, kwargs))
    ref_out = plain(*a32, **k32)
    ref_outs = ref_out if isinstance(ref_out, tuple) else (ref_out,)
    for o, ref in zip(outs, ref_outs):
        _close(o, ref, 2e-2)
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(ref_outs, weights)), up)
    scale = max(gw.norm().item() for gw in want)
    for gg, gw in zip(got, want):
        if gw.norm().item() < 1e-4 * scale:
            continue
        a, b = gg.double().flatten(), gw.double().flatten()
        assert (a @ b / (a.norm() * b.norm())).item() >= 0.9999


@pytest.mark.cuda
def test_kernels_without_a_gradient_refuse_on_the_card(gen):
    """The other kernel entries raise where autograd would record them (a
    CUDA input that requires a gradient), and launch under no_grad."""
    grid = _randn(gen, 4, 16, 16, 256).requires_grad_()
    starts = torch.zeros(4, dtype=torch.int64, device="cuda")
    with pytest.raises(RuntimeError, match="has no gradient"):
        window_crop(grid, starts, starts, 8)
    x = _randn(gen, 2, 16, 16, 64).requires_grad_()
    w = _randn(gen, 3, 3, 64, 64, std=0.05)
    with pytest.raises(RuntimeError, match="has no gradient"):
        tcv.conv2d_act(x, w, None, 3)
    wq, ws = tq.quantize_weight(_randn(gen, 256, 256, std=0.06, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="has no gradient"):
        tln.int8_linear(_randn(gen, 64, 256).requires_grad_(), wq, ws, _randn(gen, 256))
    with torch.no_grad():
        assert window_crop(grid, starts, starts, 8).shape == (4, 8, 8, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,hull_mode", [(512, 512, "polygon"), (600, 700, "polygon"),
                                           (512, 512, "reference"), (2048, 2048, "polygon")])
def test_dispatch_blocks_nowhere_once_warm(gen, h, w, hull_mode):
    """Config 1 on the card at batch 2, two batches in flight: once the
    stream is warm, a dispatch (upload, the four stages, the pack and the
    queued fetch) makes no call that blocks the host, which
    ``torch.cuda.set_sync_debug_mode("error")`` turns into a raise. Every
    constant a stage needs is on the card from the first batch. 512² frames
    need no resize; 600 x 700 and 2048² frames take the letterbox's and
    SAM's (``csrc/resample.cu``, its bands made once)."""
    import numpy as np

    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    frames = cell_frames(np.random.default_rng(6), 4, max(h, w))[:, :h, :w, 0]
    pipe = tengine.CellSegmentationPipeline(
        device="cuda", options=tengine.PipelineOptions(batch_size=2, max_det=16,
                                                       hull_mode=hull_mode))
    warm = [pipe._fetch_outputs(pipe._dispatch_batch(frames[i:i + 2])) for i in (0, 2)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [pipe._dispatch_batch(frames[i:i + 2]) for i in (0, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    outs = [pipe._fetch_outputs(hd) for hd in handles]
    for out, ref in zip(outs, warm):
        assert out["valid"].any()
        assert np.array_equal(out["valid"], ref["valid"])
        assert np.isfinite(out["boxes"]).all()


def _resample_f64(x, nh, nw):
    """The float64 resample of the frames by the same fp32 weights."""
    wy = torch.from_numpy(tpre._linear_weights(x.shape[1], nh)).to("cuda", torch.float64)
    wx = torch.from_numpy(tpre._linear_weights(x.shape[2], nw)).to("cuda", torch.float64)
    return (wy @ x.double().permute(0, 3, 1, 2) @ wx.T).permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
@pytest.mark.parametrize("h,w,size,stage", [(2048, 2048, 640, "letterbox"),
                                            (2048, 2048, 1024, "sam"),
                                            (512, 512, 640, "letterbox"),
                                            (1536, 2048, 640, "letterbox"),
                                            (1536, 2048, 1024, "sam")])
def test_resample_vs_plain(gen, h, w, size, stage, gray):
    """``csrc/resample.cu`` against the float64 resample by the same fp32
    weights, on the stage's geometry, before the epilogue (sub 0, div 1):
    within 5e-4 on the 0-255 scale (at most 8 taps of values up to 255
    summed in fp32, twice, against 1.0 for a bf16 ulp at 255), and the plain
    version (the dense einsum on the card) held to the same bound; the pad
    written exactly. Then the stage itself against its plain version on the
    CPU: pads bit-equal, the resampled area within the same 5e-4 (and an
    fp32 ulp of the normalised value)."""
    rng = np.random.default_rng(h + w + size + gray)
    if gray:  # the engine's view of a gray frame: a stride-0 channel
        u8 = torch.from_numpy(rng.integers(0, 256, (2, h, w), dtype=np.uint8))
        x = u8.cuda()[..., None].expand(2, h, w, 3)
        x_cpu = u8[:1, ..., None].expand(1, h, w, 3)
    else:
        x_cpu = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
        x, x_cpu = x_cpu.cuda(), x_cpu[:1]
    if stage == "letterbox":
        r = min(size / h, size / w)
        nh, nw = round(h * r), round(w * r)
        off = ((size - nh) // 2, (size - nw) // 2)
    else:
        r = size / max(h, w)
        nh, nw, off = int(h * r + 0.5), int(w * r + 0.5), (0, 0)
    raw = (x, (nh, nw), size, off, (0.0,) * 3, (1.0,) * 3, -1.0)
    before = tpre.resample_canvas.launches
    got = tpre.resample_canvas(*raw)
    assert tpre.resample_canvas.launches == before + 1
    plain = tpre.resample_canvas_plain(*raw)
    torch.cuda.synchronize()
    want = _resample_f64(x, nh, nw)
    inside = torch.zeros(got.shape, dtype=torch.bool, device="cuda")
    inside[:, off[0]:off[0] + nh, off[1]:off[1] + nw] = True
    for out in (got, plain):
        assert out.shape == (2, size, size, 3) and out.dtype == torch.float32
        err = (out[:, off[0]:off[0] + nh, off[1]:off[1] + nw].double() - want).abs().max().item()
        assert err <= 5e-4, err
        assert (out[~inside] == -1.0).all()

    fn = tpre.letterbox_batch if stage == "letterbox" else tpre.sam_preprocess_batch
    card, cr, cgeo = fn(x[:1], size)
    cpu, pr, pgeo = fn(x_cpu, size)
    assert (cr, cgeo) == (pr, pgeo) and card.dtype == cpu.dtype == torch.float32
    card, inside = card.cpu(), inside[:1].cpu()
    assert torch.equal(card[~inside], cpu[~inside])
    scale = torch.tensor((255.0,) * 3 if stage == "letterbox" else tpre.SAM_STD)
    err = ((card - cpu).abs() * scale)[inside].max().item()
    assert err <= 5e-4 + 255 * 2 ** -23, err


@pytest.mark.cuda
@pytest.mark.parametrize("side,launches", [(2048, 2), (512, 0)])
def test_resample_launches_a_batch_through_the_pipeline(gen, side, launches):
    """Config 1 at batch 2: 2048² frames take the letterbox's 640 and SAM's
    1024 canvas, one launch each; 512² frames (canvas 512, letterbox 512)
    resize nothing and launch none."""
    from yolo_sam_inference_tpu_torch.bench.common import cell_frames
    from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

    frames = cell_frames(np.random.default_rng(30), 2, side)[..., 0]
    pipe = tengine.CellSegmentationPipeline(
        device="cuda", options=tengine.PipelineOptions(batch_size=2, max_det=16))
    pipe.process_batch_arrays(frames)
    tpre.resample_canvas.launches = 0
    out = pipe.process_batch_arrays(frames)
    assert tpre.resample_canvas.launches == launches
    assert out["valid"].any() and np.isfinite(out["boxes"]).all()


@pytest.mark.cuda
def test_resample_refuses_what_the_kernel_does_not_take(gen):
    x = torch.zeros(1, 64, 64, 3, device="cuda")
    args = ((32, 32), 32, (0, 0), (0.0,) * 3, (1.0,) * 3, 0.0)
    with pytest.raises(ValueError, match="takes uint8 or fp32 frames"):
        tpre.resample_canvas(x.half(), *args)
    with pytest.raises(RuntimeError, match="has no gradient"):
        tpre.resample_canvas(x.requires_grad_(), *args)
    with torch.no_grad():
        assert tpre.resample_canvas(x, *args).shape == (1, 32, 32, 3)
