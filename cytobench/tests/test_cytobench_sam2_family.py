"""The ``sam2_hiera`` family (SAM 2.1 with a Hiera encoder): it loads by
path, counts Hiera-L's encoder as its shapes give it, and a tiny SAM 2
cell added as files runs correct on the CPU, and not with its reference's
masks flipped; its reference takes the program's tokens."""

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from cytobench import run, trace, weights
from cytobench.manifest import Manifest, family

from . import tiny

HERE = Path(__file__).resolve().parents[1]
CELL = "tiny-sam2-cell"

FLIP = '''
from pathlib import Path

from cytobench.manifest import family

BASE = family({"family": "sam2_hiera", "family_dir": str(Path(__file__).parent)})
globals().update({k: getattr(BASE, k) for k in dir(BASE) if not k.startswith("__")})


def crops(*args, **kwargs):
    out = BASE.crops(*args, **kwargs)
    return dict(out, logits=-out["logits"])
'''


def _published():
    return dict(json.loads((HERE / "configs" / "sam2.1-hiera-l.json").read_text()),
                family_dir=str(HERE / "families"))


def tiny_sam2(name: str = "tiny-sam2", fam: str = "sam2_hiera") -> dict:
    """Every stage transition, a global block in stage 3, head dim 8, a
    64-pixel canvas."""
    cfg = _published()
    del cfg["family_dir"]
    cfg.update(name=name, family=fam, dtype="float32", image_size=64)
    cfg["trunk"].update(embed_dim=16, num_heads=2, stages=[1, 2, 2, 1], global_att_blocks=[4],
                        window_pos_embed_bkg_spatial_size=[3, 3], window_spec=[4, 2, 2, 2])
    cfg["neck"].update(d_model=32, backbone_channel_list=[128, 64, 32, 16])
    cfg["prompt_encoder"].update(embed_dim=32, image_embedding_size=[4, 4],
                                 input_image_size=[64, 64])
    cfg["mask_decoder"].update(transformer_dim=32, num_heads=2, mlp_dim=32, iou_head_hidden_dim=16)
    cfg["assumed"]["ln_outlier_z"] = 1.5
    return cfg


def test_the_family_loads_by_path():
    fam = family(_published())
    assert fam.ENCODER_CLASS == "HieraImageEncoder"
    assert Path(fam.__file__) == HERE / "families" / "sam2_hiera.py"


def test_encoder_units_total_hiera_l():
    """1.82 TFLOP a 1024-canvas frame: qkv, projection, the shortcut's
    projection, MLP, attention as 4 q k dim, the patch embedding, the neck
    and the high-resolution convs (by part: 2.8 + 70 + 212 + 1381 +
    146 + 11 GFLOP)."""
    cfg = _published()
    total = sum(f for f, _, _ in family(cfg).encoder_units(cfg))
    assert abs(total / 1.82e12 - 1) < 0.02, total
    assert len(family(cfg).encoder_units(cfg)) == 1 + 48 + 1


def test_the_reference_takes_the_programs_token():
    """Given the tokens a program noted for a batch's boxes, the reference's
    crops are those tokens' masks; unnoted boxes get its own choice."""
    cfg = tiny_sam2()
    cfg["family_dir"] = str(HERE / "families")
    fam = family(cfg)
    traffic = dict(tiny.tiny_traffic(), frame_size=64, metric_crop=32)
    stree = weights.weights(cfg, 3, "cpu", host=False)[1]
    frames = torch.as_tensor(np.random.default_rng(3).integers(0, 255, (2, 64, 64)),
                             dtype=torch.uint8)
    boxes = torch.tensor([[[4.0, 4.0, 30.0, 40.0], [20.0, 10.0, 60.0, 50.0]]] * 2)
    boxes[1] += 1.0
    valid = torch.tensor([[True, True], [True, False]])
    with torch.inference_mode():
        emb = fam.embed(stree, frames, cfg, traffic)
        own = fam.crops(stree, emb, boxes, valid, (64, 64), cfg, traffic)
        taken = torch.where(valid, (own["token"] + 1) % 4, -1)
        fam._CHOICES.clear()  # a batch noted again with other tokens reads as varied
        fam.note(boxes, taken)
        got = fam.crops(stree, emb, boxes, valid, (64, 64), cfg, traffic)
        for t in range(4):
            fam._CHOICES.clear()
            fam.note(boxes, torch.where(valid, t, -1))
            each = fam.crops(stree, emb, boxes, valid, (64, 64), cfg, traffic)
            pick = valid & (taken == t)
            assert torch.equal(got["logits"][pick], each["logits"][pick])
    assert torch.equal(got["token"], taken)
    assert torch.equal(got["logits"][~valid], own["logits"][~valid])
    fam.note(boxes, torch.where(valid, 0, -1))  # seen again, other tokens: none is taken
    again = fam.crops(stree, emb, boxes, valid, (64, 64), cfg, traffic)
    fam._CHOICES.clear()
    assert torch.equal(again["token"], own["token"])


@pytest.mark.parametrize("flip", [False, True], ids=["faithful", "flipped"])
def test_a_tiny_sam2_cell_is_correct(tiny_root, monkeypatch, flip):
    """The tiny SAM 2 cell, new files only: a traced CPU run is correct, reads
    the encoder's roofline, the step's MFU and the three SAM 2 spans; with the
    reference's masks flipped by the family it is not correct. A CPU profile
    has no device time, so each marked encoder call is given 1 ms of it."""
    none = {"window_s": 0.0, "busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    read = trace.read
    monkeypatch.setattr(trace, "read", lambda events: dict(
        read(events) or none, encoder_s=[1e-3 for e in events if e.name == trace.ENCODER]))
    root = Path(tempfile.mkdtemp(prefix="cytobench_sam2_"))
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    here = root / "cytobench"
    fam = "sam2_flip" if flip else "sam2_hiera"
    if flip:
        (here / "families" / "sam2_flip.py").write_text(FLIP)
    (here / "configs" / "tiny-sam2.json").write_text(json.dumps(tiny_sam2(fam=fam)))
    shutil.copy(here / "workloads" / f"{tiny.CELL}.json", here / "workloads" / f"{CELL}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-sam2", "source": "test",
                             "file": "cytobench/configs/tiny-sam2.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-sam2", "traffic": "tiny",
                               "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run.run_cell(Manifest(root, here), CELL, 5, 0.3, True, "cpu")
    if flip:
        assert not line["correct"], line["compared"]
        return
    assert line["correct"], line["compared"]
    assert {"encoder_roofline", "mfu_pct", "hiera_fine_ms", "hiera_coarse_ms",
            "sam2_head_ms"} <= set(line["metrics"])
    assert line["metrics"]["hiera_fine_ms"]["value"] < line["metrics"]["embed_ms"]["value"]
    assert line["metrics"]["sam2_head_ms"]["value"] < line["metrics"]["segment_ms"]["value"]
