"""Readings for a cell's comparison limits: the program's sound runs and the
controls, each judged by ``cytobench/judge.py`` on the cell's sizes.

    python3 -m cytobench.control --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--seconds 3] [--out chiprun_out/control.jsonl]

For each seed of ``--seeds``: a short window of the cell's stream (the same
set-up and sampled batches as a run), its numbers. For each seed of
``--control-seeds``: the same with the program's own int8 path
(``PipelineOptions(quant="int8")``: w8a8 qkv and MLP in the encoder), and
the reference put in the program's place one precision lower (every
product of YOLO, the encoder and the decoder on float8 e4m3 steps, the
metrics in bfloat16).
One JSON line a reading, then a summary line: each number's largest sound
reading and each control's smallest. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np


def reference_control(manifest, name: str, seed: int, device) -> Dict[str, float]:
    """The numbers of the reference in the program's place one precision
    lower: its products and outputs on float8 steps, its metrics in bfloat16."""
    import torch

    from . import judge, traffic as gen, weights
    from .reference import fp32_exact
    from .reference import pipeline as rpipe

    fp32_exact()
    cell = manifest.cell(name)
    cfg, traffic = manifest.config(cell), manifest.traffic(cell)
    pool = gen.frame_pool(seed, traffic)
    trees = weights.weights(cfg, seed, device, host=False)
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(pool), size=min(traffic["check_batches"], len(pool)), replace=False)
    batches = []
    with torch.inference_mode():
        for i in picks:
            out = rpipe.pipeline(trees, torch.as_tensor(pool[i], device=device), cfg, traffic,
                                 quant="fp8", work=torch.bfloat16)
            host = {k: v.float().cpu().numpy() if k != "valid" and k != "mask_crops"
                    else v.cpu().numpy() for k, v in out.items() if k != "metrics"}
            host["offsets"] = out["offsets"].cpu().numpy()
            host["metrics"] = {k: v.double().cpu().numpy() for k, v in out["metrics"].items()}
            batches.append((pool[i], host))
    return judge.numbers(cfg, traffic, trees, batches, device)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="chiprun_out/control.jsonl")
    args = ap.parse_args(argv)

    from . import judge
    from .manifest import Manifest
    from .run import ROOT, run_cell

    manifest = Manifest(ROOT)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows: List[Dict] = []

    def emit(row):
        rows.append(row)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        line = run_cell(manifest, args.workload, seed, args.seconds, False, "cuda")
        emit({"mode": "program", "seed": seed, "correct": line["correct"],
              "numbers": {k: v["value"] for k, v in line["compared"].items()},
              "metrics": {k: v["value"] for k, v in line["metrics"].items()}})
    for seed in control_seeds:
        line = run_cell(manifest, args.workload, seed, args.seconds, False, "cuda", quant="int8")
        emit({"mode": "program int8", "seed": seed, "correct": line["correct"],
              "numbers": {k: v["value"] for k, v in line["compared"].items()}})
        emit({"mode": "reference fp8", "seed": seed,
              "numbers": reference_control(manifest, args.workload, seed, "cuda")})
    summary = {}
    for k in judge.NUMBERS:  # a program run's line holds only the numbers with a limit
        summary[k] = {m: (max if m == "program" else min)(r["numbers"][k] for r in rows
                                                         if r["mode"] == m and k in r["numbers"])
                      for m in ("program", "program int8", "reference fp8")
                      if any(r["mode"] == m and k in r["numbers"] for r in rows)}
    emit({"mode": "summary", "numbers": summary})
    return 0


if __name__ == "__main__":
    sys.exit(main())
