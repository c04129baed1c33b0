"""A whole run of a cell on the CPU at a tiny size, the kernels' plain
versions in place of the CUDA kernels (`kernels_impl="auto"` on the CPU)."""
from __future__ import annotations

import time

#: sizes at which a CPU run takes seconds; the sparse one stays above the
#: 2048 points up to which the sparse start uses the dense eigensolver
TINY = {"mnist20k-dense.ee-sd": {"n": 400, "dim": 30},
        "tenx1m3-sparse.tsne-sd": {"n": 2600, "dim": 50}}


def cpu_run(cell_name: str, seed: int = 7, trace: bool = False,
            control: bool = False) -> dict:
    from harness import cell as cell_run
    from harness.env import prepare_environment
    from harness.manifest import Cell
    prepare_environment()
    return cell_run.run(Cell(cell_name), seed, 0.01, trace,
                        t_start=time.perf_counter(), device="cpu",
                        require_device=False, control=control,
                        config_overrides=TINY[cell_name])
