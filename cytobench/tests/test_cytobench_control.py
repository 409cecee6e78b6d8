"""The controls of cytobench/control.py at the tiny cell on the CPU: the
reference one precision lower in the program's place, and the program's own
int8 path, each come out not correct under the cell's limits (the chip's
readings at the cells' sizes are in PERF.md)."""

from cytobench import control, judge, run
from cytobench.manifest import Manifest

from . import tiny


def test_reference_one_precision_lower_is_not_correct(tiny_root):
    m = Manifest(tiny_root, tiny_root / "cytobench")
    got = control.reference_control(m, tiny.CELL, 31, "cpu")
    ok, table = judge.verdict(got, m.limits(m.cell(tiny.CELL)))
    assert not ok, table


def test_programs_int8_path_is_not_correct(tiny_root):
    m = Manifest(tiny_root, tiny_root / "cytobench")
    line = run.run_cell(m, tiny.CELL, 32, 0.3, False, "cpu", quant="int8")
    assert not line["correct"], line["compared"]
