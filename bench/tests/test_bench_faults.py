"""The check of `correct` refuses a run whose timed path is broken
underneath: the harness's look for a chip is skipped and the rest of a
run is driven on the CPU at a tiny size with each fault a cell can have
planted in the program (`faults.py`); a one-chip cell has no exchange
between chips to leave out."""
import pytest

import faults
from helpers import TINY, cpu_run

CASES = [(cell, f) for cell in sorted(TINY)
         for f in ("stuck", "half_batch", "altered", "wrong_start", "stale")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    from harness.env import import_program
    import_program()
    with faults.FAULTS[fault]():
        res = cpu_run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct_where_it_reaches(cell):
    """The control, the program's own bfloat16 path; on the CPU its plain
    kernels round the storage as the card's do."""
    res = cpu_run(cell, control=True)
    assert res["correct"] is False, res["checks"]
