"""The result line's keys, in both kinds of run, from the tiny cell on the CPU."""

import json

from cytobench import run
from cytobench.manifest import Manifest

from . import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_end_to_end_line(tiny_root):
    m = Manifest(tiny_root, tiny_root / "cytobench")
    line = run.run_cell(m, tiny.CELL, 21, 0.3, False, "cpu")
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"images_per_s", "setup_s"}  # p95 needs 20 batches
    assert line["device"]["platform"] == "cpu" and line["attempted"] >= line["failed"] >= 0
    assert all(set(v) == {"value", "limit"} for v in line["compared"].values())
    json.dumps(line)


def test_traced_line(tiny_root):
    m = Manifest(tiny_root, tiny_root / "cytobench")
    line = run.run_cell(m, tiny.CELL, 22, 0.3, True, "cpu")
    names = {x["name"] for x in m.metrics(m.cell(tiny.CELL), True)}
    # no card: the profiler sees no kernel, so the device's readers have nothing to read
    assert set(line["metrics"]) == names - {"idle_pct", "encoder_roofline"}
    assert list(line)[-1] == "compared"


def test_refuses_without_a_card(capsys):
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    assert run.main(["--workload", "vitb-512-b128", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
