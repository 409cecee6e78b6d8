"""The bare bf16 GEMM (bias only, no LayerNorm) beside ``torch.addmm``.

    python -m yolo_sam_inference_tpu_torch.bench.gemm_shapes

At the encoder's batch-32 shapes (32768 rows): ViT-B's qkv, mlp1 and mlp2,
ViT-H's qkv and mlp2. Each shape is timed in turns (kernel, addmm, addmm,
kernel; CUDA events, median of 20) on the same bf16 inputs, with the
kernel's rate in TFLOP/s and its max abs error against the fp32 product.
Needs one card.
"""

from __future__ import annotations

SHAPES = (  # (label, M, K, N)
    ("ViT-B qkv", 32768, 768, 2304),
    ("ViT-B mlp1", 32768, 768, 3072),
    ("ViT-B mlp2", 32768, 3072, 768),
    ("ViT-H qkv", 32768, 1280, 3840),
    ("ViT-H mlp2", 32768, 5120, 1280),
)


def main() -> None:
    import torch

    from yolo_sam_inference_tpu_torch.bench.common import card, median_ms
    from yolo_sam_inference_tpu_torch.ops import fused_ln as F

    print(card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    for label, m, k, n in SHAPES:
        a = torch.randn(m, k, generator=g).to("cuda", torch.bfloat16)
        w = (torch.randn(k, n, generator=g) * k ** -0.5).to("cuda", torch.bfloat16)
        b = (torch.randn(n, generator=g) * 0.1).cuda()
        kern = lambda: F.gemm_bf16(a, w, b)
        lib = lambda: torch.addmm(b.to(torch.bfloat16), a, w)
        err = (kern().float() - (a.float() @ w.float() + b)).abs().max().item()
        t = [median_ms(kern), median_ms(lib), median_ms(lib), median_ms(kern)]
        tf = 2.0 * m * k * n / (min(t[0], t[3]) * 1e-3) / 1e12
        print(f"{label} ({m}x{k} @ {k}x{n}): gemm_bf16 {t[0]:.4f}, {t[3]:.4f} ms "
              f"({tf:.0f} TFLOP/s), addmm {t[1]:.4f}, {t[2]:.4f} ms; max_abs_err {err:.4f}",
              flush=True)
        del a, w


if __name__ == "__main__":
    main()
