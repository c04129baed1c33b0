"""Read the numbers that decide `correct` over many seeds in one process
(the set-up is long, so the kernels load once): the program's sound runs
give each number's lower reading, the control (`--control`: the program's
bfloat16 path) and the planted faults (`faults.py`) its upper ones.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--faults stuck,half_batch] [--fault-seeds 7,8,9]

Each run is a whole run of the cell (`harness/cell.py`) with a window of
`--seconds` (one fit at the least); one JSON line a run goes to standard
output: its kind, seed, `correct`, the numbers and the phases' seconds."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.env import prepare_environment  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.1)
    args = p.parse_args(argv)
    prepare_environment()
    import torch
    torch.set_num_threads(4)
    import faults
    from harness import cell as cell_run
    from harness.env import import_program
    from harness.manifest import Cell
    import_program()
    cell = Cell(args.workload)
    plan = [("program", s, None) for s in _seeds(args.seeds)]
    plan += [("control", s, None) for s in _seeds(args.control_seeds)]
    plan += [(f, s, f) for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    for kind, seed, fault in plan:
        t0 = time.perf_counter()
        ctx = faults.FAULTS[fault]() if fault else _nothing()
        try:
            with ctx:
                res = cell_run.run(cell, seed, args.seconds, False,
                                   t_start=time.perf_counter(),
                                   control=kind == "control")
            row = {"kind": kind, "seed": seed, "correct": res["correct"],
                   "numbers": {**res["readings"],
                               **{k: v["value"] for k, v in
                                  res["checks"].items()}},
                   "phases": res["phases"],
                   "iter_ms": next(v["value"] for k, v in
                                   res["metrics"].items()
                                   if k.endswith("iter_ms"))}
        except Exception as e:          # a crashed fault run has failed
            row = {"kind": kind, "seed": seed, "error": repr(e)[:500]}
        row["wall_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


if __name__ == "__main__":
    sys.exit(main())
