"""Time PR-comparable kernel calls of one checkout's port, for runs in turns.

    python yolo_sam_inference_tpu_torch/bench/kernel_turns.py --tree DIR --tag NAME

Imports ``yolo_sam_inference_tpu_torch`` from the checkout at DIR (its
kernels build into DIR/build/), so the same script times two trees: run it
for the parent, the change, the change and the parent, each in its own
process, and compare the medians. It times, on batch-32 inputs made from
seed 0 (CUDA events, median of 20 calls): ``t2i_attend`` (K6, 32 images x 16
prompts x 7 tokens, k/v shared per image) at T 196, 784, 1024 and 4096;
``fused_ln_matmul`` (K1) and ``fused_ln_mlp`` (K4 at ViT-B, K10 at ViT-L and
ViT-H) at 32768 rows. Prints the card, then one ``[TAG] name: ms`` line per
call. Needs one card.
"""

from __future__ import annotations

import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True, help="root of the checkout whose port to time")
    ap.add_argument("--tag", required=True)
    args = ap.parse_args()
    sys.path.insert(0, args.tree)

    import torch

    from yolo_sam_inference_tpu_torch.bench.common import card, median_ms
    from yolo_sam_inference_tpu_torch.ops import decoder_fused as dec
    from yolo_sam_inference_tpu_torch.ops import fused_ln as tln

    assert tln.__file__.startswith(args.tree), tln.__file__
    print(card(), flush=True)
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def rn(*shape, std=1.0):
        return (torch.randn(*shape, generator=g) * std).to("cuda")

    b, k, tq = 32, 16, 7
    qp = rn(b * k, tq, 128, std=0.25).to(bf)
    for t in (196, 784, 1024, 4096):
        kp, vp = rn(b, t, 128).to(bf), rn(b, t, 128).to(bf)
        ms = median_ms(lambda: dec.t2i_attend(qp, kp, vp, 8, k))
        print(f"[{args.tag}] t2i_attend T{t}: {ms:.4f}", flush=True)
    m = 32 * 1024
    for name, c in (("ViT-B", 768), ("ViT-L", 1024), ("ViT-H", 1280)):
        x, h = rn(m, c).to(bf), rn(m, c).to(bf)
        s, bb = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        wq, bq = rn(c, 3 * c, std=c ** -0.5).to(bf), rn(3 * c, std=0.1)
        w1, b1 = rn(c, 4 * c, std=c ** -0.5).to(bf), rn(4 * c, std=0.1)
        w2, b2 = rn(4 * c, c, std=(4 * c) ** -0.5).to(bf), rn(c, std=0.1)
        k1 = median_ms(lambda: tln.fused_ln_matmul(x, s, bb, wq, bq))
        tail = median_ms(lambda: tln.fused_ln_mlp(x, h, s, bb, w1, b1, w2, b2))
        print(f"[{args.tag}] K1 {name}: {k1:.4f}", flush=True)
        print(f"[{args.tag}] {'K4' if c == 768 else 'K10'} {name}: {tail:.4f}", flush=True)
        del x, h, wq, w1, w2
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
