"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (the CPU, tiny sizes, the real
cells' limits), and each fault a cell can have (``portbench/faults.py``)
is planted in the port."""

from __future__ import annotations

import pytest
import torch

from portbench import faults, harness, run
from portbench.tests import tiny

CASES = [(cell, fault) for cell in sorted(tiny.SIZES)
         for fault in sorted(faults.for_kind(
             harness.load_cell(cell).mix["kind"]))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault, tmp_path):
    name = tiny.write(str(tmp_path), cell)
    kind = harness.load_cell(cell).mix["kind"]
    with faults.for_kind(kind)[fault]():
        result = run.run_cell(harness.load_cell(name, str(tmp_path)),
                              2 ** 31 + 303, 0.2, False, torch.device("cpu"))
    assert result["correct"] is False, result["checks"]
