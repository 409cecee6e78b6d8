"""BENCHMARK.json against the benchmark's contract, and name discovery: every
configuration, traffic mix, cell and metric is a file found by its name, and
a new one is added as new files without an edit to any file there is."""

import json
import re
import shutil
import tempfile
from pathlib import Path

import pytest

from cytobench import run, trace
from cytobench.manifest import Manifest

from . import tiny

ROOT = tiny.REPO
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cytobench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check with the most cells later PRs may reach must fit its budget
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cytobench/")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200 for w in BENCH["workloads"])


def test_every_name_has_its_file():
    m = Manifest(ROOT)
    for w in BENCH["workloads"]:
        cell = m.cell(w["name"])
        assert m.config(cell)["name"] == w["config"]
        assert m.traffic(cell)["batch"] > 0
        assert set(m.limits(cell)) >= {"box_ratio", "mask_flip_ratio", "metric_rel"}
        for trace in (False, True):
            for metric in m.metrics(cell, trace):
                assert callable(m.reader(metric, trace))


def test_a_cell_and_a_metric_are_added_as_files_only(tiny_root):
    """The tiny cell (tiny.make) and a dummy per-layer metric are new files
    and new entries; no file that was there changes, and a run reports the
    new metric in the new cell."""
    root = Path(tempfile.mkdtemp(prefix="cytobench_add_"))
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    before = {p: p.read_bytes() for p in (root / "cytobench").rglob("*") if p.is_file()}
    (root / "cytobench" / "metrics" / "frames_seen.py").write_text(
        "def read(rec):\n    return float(rec['window']['images'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "frames_seen", "unit": "img", "better": "higher",
                               "source": "host_clock", "layer": "batch stream",
                               "moves": "images_per_s", "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run.run_cell(Manifest(root, root / "cytobench"), tiny.CELL, 3, 0.3, True, "cpu")
    assert line["metrics"]["frames_seen"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())



PROBE = '''"""A family that hands every hook to sam_vit's and counts its calls."""
import collections
from pathlib import Path

from cytobench.manifest import family

CALLS = collections.Counter()
BASE = family({"family": "sam_vit", "family_dir": str(Path(__file__).parent)})
ENCODER_CLASS = BASE.ENCODER_CLASS
HOOKS = ("sam_spec", "build", "encoder_units", "prompt_flops", "embed", "crops")


def _counted(name):
    def hook(*args, **kwargs):
        CALLS[name] += 1
        out = getattr(BASE, name)(*args, **kwargs)
        return FLIP(out) if name == "crops" else out
    return hook


for _name in HOOKS:
    globals()[_name] = _counted(_name)
'''


@pytest.mark.parametrize("name,flip", [("probe", "out"),
                                       ("probe_flip", "dict(out, logits=-out['logits'])")],
                         ids=["faithful", "flipped"])
def test_a_family_is_added_as_files_only(tiny_root, monkeypatch, name, flip):
    """A new model family is a module in families/, a configuration that
    names it and a cell, all new files and entries: a run of the cell calls
    every hook, reads the encoder's roofline and the step's MFU, and is
    correct; with the reference's masks flipped by the family, it is not.
    No file that was there changes. A CPU profile has no device time, so
    each marked encoder call is given 1 ms of it."""
    none = {"window_s": 0.0, "busy_s": 0.0, "device_ops": [], "idle_gaps": []}
    read = trace.read
    monkeypatch.setattr(trace, "read", lambda events: dict(
        read(events) or none, encoder_s=[1e-3 for e in events if e.name == trace.ENCODER]))
    root = Path(tempfile.mkdtemp(prefix="cytobench_family_"))
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    here = root / "cytobench"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "families" / f"{name}.py").write_text(PROBE + f"\n\ndef FLIP(out):\n    return {flip}\n")
    (here / "configs" / f"{name}.json").write_text(json.dumps(dict(tiny.tiny_config(),
                                                                   name=name, family=name)))
    cell = f"{name}-cell"
    shutil.copy(here / "workloads" / f"{tiny.CELL}.json", here / "workloads" / f"{cell}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "file": f"cytobench/configs/{name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": "tiny", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(root, here)
    line = run.run_cell(m, cell, 3, 0.3, True, "cpu")
    assert all(p.read_bytes() == b for p, b in before.items())
    if name == "probe_flip":
        assert not line["correct"], line["compared"]
        return
    assert line["correct"], line["compared"]
    assert {"encoder_roofline", "mfu_pct"} <= set(line["metrics"])
    probe = m.family({"family": name})
    assert all(probe.CALLS[h] > 0 for h in probe.HOOKS), probe.CALLS


def test_a_configuration_without_a_family_is_refused(tiny_root):
    root = Path(tempfile.mkdtemp(prefix="cytobench_nofamily_"))
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    path = root / "cytobench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    del cfg["family"]
    path.write_text(json.dumps(cfg))
    m = Manifest(root, root / "cytobench")
    with pytest.raises(KeyError, match='"family"'):
        m.config(m.cell(tiny.CELL))
