"""``gemm_bf16`` with its LayerNorm against the LayerNorm kernel + the bare product.

    python -m yolo_sam_inference_tpu_torch.bench.ab_ln_prologue

At the config-1 batch-32 shapes (32768 rows, C = 768): K1 (LN1 + qkv) and
the MLP's first product (add + LN2 + GELU). "fused" is one ``gemm_bf16``
call (its own LN pass, then the product on the normalised rows); "separate"
is ``layer_norm`` (K5's kernel, residual form for the MLP) followed by
``gemm_bf16`` without its LN. Each is run both ways on the same bf16 inputs,
timed in turns (fused, separate, separate, fused, CUDA events, median of 20),
and checked against the fp32 plain version. Needs one card.
"""

from __future__ import annotations


def main() -> None:
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import card, median_ms
    from yolo_sam_inference_tpu_torch.ops import fused_ln as F

    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator().manual_seed(0)

    def rn(*s, std=1.0):
        return (torch.randn(*s, generator=g) * std).to(dev)

    m, c = 32768, 768
    x, h = rn(m, c).to(bf), rn(m, c).to(bf)
    s, b = 1 + rn(c, std=0.1), rn(c, std=0.1)
    wq, bq = rn(c, 3 * c, std=c ** -0.5).to(bf), rn(3 * c, std=0.1)
    w1, b1 = rn(c, 4 * c, std=c ** -0.5).to(bf), rn(4 * c, std=0.1)
    cases = {
        "K1 ln+qkv": (
            lambda: F.gemm_bf16(x, wq, bq, ln=(s, b, 1e-6)),
            lambda: F.gemm_bf16(F.layer_norm(x, s, b, 1e-6), wq, bq),
            lambda: F.gemm_plain(x.float(), wq, bq, ln=(s, b, 1e-6))),
        "mlp1 add+ln+gelu": (
            lambda: F.gemm_bf16(x, w1, b1, a2=h, ln=(s, b, 1e-6), gelu=True),
            lambda: F.gemm_bf16(F.layer_norm(x, s, b, 1e-6, residual=h)[1], w1, b1, gelu=True),
            lambda: F.gemm_plain(x.float(), w1, b1, a2=h.float(), ln=(s, b, 1e-6), gelu=True)),
    }
    for name, (fused, separate, ref) in cases.items():
        want = ref()
        err = [(fn().float() - want).abs().max().item() for fn in (fused, separate)]
        t = [median_ms(fused), median_ms(separate), median_ms(separate), median_ms(fused)]
        print(f"{name}: max_abs_err fused {err[0]:.5f} separate {err[1]:.5f} "
              f"(max|ref| {want.abs().max().item():.3f}); ms fused {t[0]:.4f}, separate "
              f"{t[1]:.4f}, separate {t[2]:.4f}, fused {t[3]:.4f}", flush=True)


if __name__ == "__main__":
    main()
