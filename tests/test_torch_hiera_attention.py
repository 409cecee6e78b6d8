"""SAM 2's Hiera attention kernel (``csrc/hiera_attention.cu``) on the card.

Every test here needs an NVIDIA GPU and skips elsewhere; the file imports no
jax, so run it without the conftest:

    python -m pytest --noconftest tests/test_torch_hiera_attention.py -q

The kernel takes bf16 q, k, v, accumulates q.k^T and P.V in fp32 and rounds
P and the output to bf16; the plain version runs in fp32 on the same bf16
inputs. Each output is a convex combination of v rows, so the two bf16
roundings (each 2^-9 of a value) stay far inside 2% of the output's range,
the bound of the other attention kernels' tests (``test_torch_cuda.py``); a
wrong key, query, scale or head moves outputs by tens of percent of it.
"""

import collections

import pytest
import torch

from yolo_sam_inference_tpu_torch.models.sam import init_sam2_params, sam2_1_hiera_l
from yolo_sam_inference_tpu_torch.ops.hiera_attention import (
    hiera_window_attention,
    hiera_window_attention_plain,
)
from yolo_sam_inference_tpu_torch.weights import from_jax_params

CFG = sam2_1_hiera_l()
# Hiera-L's attention cases at the 1024 canvas: (grid, heads, window, pool)
CASES = list(dict.fromkeys(CFG.attention()))


def _case_id(case):
    grid, _, window, pool = case
    return f"g{grid}-{f'w{window}' if window else 'global'}{'-pooled' if pool else ''}"


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 oracle stays fp32
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _close(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= rtol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["3c-rows", "4c-rows"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_plain(gen, case, wide):
    """Batch 2 at each case's real grid; with ``wide`` qkv is the first 3C
    columns of a (tokens, 4C) product, as at a pooling block. q and k at
    std 2 give peaked softmaxes (logits of about +-4 hd^-0.5 * 72)."""
    s, heads, window, pool = case
    c = heads * 72
    y = (torch.randn(2 * s * s, (4 if wide else 3) * c, generator=gen) * 2).to("cuda",
                                                                             torch.bfloat16)
    qkv = y[:, :3 * c].reshape(2, s, s, 3 * c)
    before = hiera_window_attention.launches
    got = hiera_window_attention(qkv, heads, window, pool)
    torch.cuda.synchronize()
    assert hiera_window_attention.launches == before + 1
    want = hiera_window_attention_plain(qkv, heads, window, pool)
    side = s // 2 if pool else s
    assert got.shape == (2, side, side, c) and got.dtype == torch.bfloat16
    _close(got, want, 2e-2)


@pytest.mark.cuda
def test_encoder_forward_launches_and_no_library_attention(gen):
    """One Hiera-L encoder forward (batch 1, 1024 canvas, bf16) adds one
    launch a block, counted under each block's case of ``attention()`` (48
    in all), and its profile holds no SDPA, flash or fused-attention kernel
    from cuDNN or PyTorch."""
    _, sam = from_jax_params(None, init_sam2_params(0, CFG), "cuda", torch.bfloat16,
                             sam_config=CFG)
    pix = torch.randn(1, CFG.image_size, CFG.image_size, 3, generator=gen).to("cuda",
                                                                             torch.bfloat16)
    with torch.inference_mode():
        sam.vision(pix)  # builds and warms
        torch.cuda.synchronize()
        before = hiera_window_attention.launches
        by_window = dict(hiera_window_attention.by_window)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            sam.vision(pix)
            torch.cuda.synchronize()
    assert hiera_window_attention.launches == before + len(CFG.blocks()) == before + 48
    added = {k: n - by_window.get(k, 0) for k, n in hiera_window_attention.by_window.items()}
    assert {k: n for k, n in added.items() if n} == dict(
        collections.Counter((grid, window, pool) for grid, _, window, pool in CFG.attention()))
    names = {e.key for e in prof.key_averages()}
    assert any("hiera_attn_kernel" in n for n in names), sorted(names)
    library = [n for n in names if any(k in n.lower() for k in ("sdpa", "flash", "fmha",
                                                                "scaled_dot_product"))]
    assert not library, library
