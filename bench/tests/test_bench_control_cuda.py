"""On the card: the control of the correctness check, the program's own
bfloat16 path, comes out not correct in each cell, at sizes a test run can
hold (the harness's own runs never run it; `calibrate.py` reads it at the
cells' sizes).  Run on the chip with

    python3 -m pytest -q -m cuda bench/tests/test_bench_control_cuda.py
"""
import time

import pytest

SIZES = {"mnist20k-dense.ee-sd": {"n": 5000},
         "tenx1m3-sparse.tsne-sd": {"n": 200000}}


def _run(cell_name, control):
    from harness import cell as cell_run
    from harness.env import prepare_environment
    from harness.manifest import Cell
    prepare_environment()
    return cell_run.run(Cell(cell_name), 2147483921, 0.01, False,
                        t_start=time.perf_counter(), control=control,
                        config_overrides=SIZES[cell_name])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_is_not_correct(cell, cuda_device):
    assert _run(cell, control=True)["correct"] is False
