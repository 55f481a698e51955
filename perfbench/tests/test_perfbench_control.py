"""The control at a size a test holds: the float8 reference put in the
program's place fails the tiny cells' limits, where the program passes them
(the chip's readings at the cells' own sizes: ``python3 -m
perfbench.control`` and PERF.md)."""

import pytest

from perfbench import check, control
from perfbench.tests import cells


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
@pytest.mark.parametrize("seed", [5, 2**31 + 99, 2**33 + 1])
def test_control_fails_where_the_program_passes(tmp_path, cell, seed):
    root = cells.write(tmp_path)
    out = control.one_seed(root, cell, seed, 1.0, "cpu", lambda m: None)
    assert out["requests"] >= 2
    assert check.verdict(out["program"], cells.LIMITS)
    assert not check.verdict(out["control"], cells.LIMITS)


def test_control_reads_a_planted_fault(tmp_path):
    """``--fault``: the program's numbers with the fault planted, judged by
    the cell's limits, and no control."""
    root = cells.write(tmp_path)
    out = control.one_seed(root, "tiny-open", 2**31 + 7, 1.0, "cpu", lambda m: None,
                           fault="half_batch")
    assert out["fault"] == "half_batch" and out["not_correct"] is True
    assert "control" not in out
