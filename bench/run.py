"""The benchmark of the PyTorch and CUDA port (`repro_torch`): one run of
one cell, printed as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's CUDA devices.
`BENCHMARK.json` lists the cells, their metrics and `run_seconds`; each
cell's configuration, data, traffic, limits, metric readers and reference
are found by name under `bench/` (`harness/manifest.py`).  With `--trace 0`
the line holds the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics and the device's busy and traced seconds.  The numbers
that decide `correct` are printed beside their limits as the last lines
of standard error and under `checks`, the line's last key.

The control of the correctness check, and the planted faults, are read
over seeds by `bench/calibrate.py`.  Without CUDA, or with fewer
cards than the cell asks for, or with a module of JAX loaded once the
window has closed, the run prints no result and exits with a code other
than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.env import Refusal, forbidden_modules_loaded  # noqa: E402
from harness.env import prepare_environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    prepare_environment()
    from harness import cell as cell_run
    from harness.manifest import Cell
    try:
        import torch
        torch.set_num_threads(4)
        result = cell_run.run(Cell(args.workload), args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
        # after the window and the reference: nothing of JAX in this process
        loaded = forbidden_modules_loaded()
        if loaded:
            raise Refusal("modules of JAX or of the JAX package are loaded "
                          "in this process: " + ", ".join(loaded))
    except Refusal as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
