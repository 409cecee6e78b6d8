"""A tiny cell for the CPU tests: a copy of the benchmark under a temporary
root with one more configuration, traffic mix and cell, added as files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
CELL = "tiny-cell"


def tiny_config(dtype: str = "float32") -> dict:
    cfg = json.loads((HERE / "configs" / "sam-vit-b.json").read_text())
    cfg["name"] = "tiny"
    cfg["dtype"] = dtype
    cfg["vision_config"].update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                mlp_dim=64, patch_size=8, image_size=256,
                                global_attn_indexes=[1], output_channels=16)
    cfg["prompt_encoder_config"].update(hidden_size=16)
    cfg["mask_decoder_config"].update(hidden_size=16, num_attention_heads=2, mlp_dim=32,
                                      iou_head_hidden_dim=16)
    # 32 channels hold no 2.5-sigma gain at all: outliers from 1.5 sigma
    cfg["assumed"]["ln_outlier_z"] = 1.5
    return cfg


def tiny_traffic() -> dict:
    t = json.loads((HERE / "traffic" / "gray512-12cells-b128.json").read_text())
    t.update(frame_size=160, cells_per_frame=2, batch=4, max_det=4, warmup_batches=2,
             check_batches=2, synced_batches=1, profiled_batches=2)
    return t


def make(root: Path, dtype: str = "float32", limits: dict = None,
         like: str = "vitb-512-b128") -> Path:
    """The benchmark copied to ``root`` with the tiny cell added, under the
    limits of the cell ``like`` (updated by ``limits``); returns root."""
    root = Path(root)
    dst = root / "cytobench"
    shutil.copytree(HERE, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "configs" / "tiny.json").write_text(json.dumps(tiny_config(dtype)))
    (dst / "traffic" / "tiny.json").write_text(json.dumps(tiny_traffic()))
    base = json.loads((HERE / "workloads" / f"{like}.json").read_text())
    if limits:
        base["limits"].update(limits)
    (dst / "workloads" / f"{CELL}.json").write_text(json.dumps(base))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test", "file": "cytobench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny", "traffic": "tiny", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
