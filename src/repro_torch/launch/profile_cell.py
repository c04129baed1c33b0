"""Dry-run profiler: the matmuls of one cell by FLOPs summed over their
repeats.  Port of `repro/launch/profile_cell.py`:

    PYTHONPATH=src python -m repro_torch.launch.profile_cell --arch grok-1-314b \\
        --shape prefill_32k [--overrides '{"attn_q_chunk": 0}']

It counts the cell as `launch/dryrun.py` does (on `meta`, rank 0 of a fake
process group: a train cell is the sharded step, its matmuls on this
rank's "model" blocks; the embedding cell for an embedding arch; fitted
where a direct count takes too long) and prints the totals a chip, MODEL_FLOPS
against them, and `hlo_cost.top_flops`: the code location of each matmul
(file:line:function in `src/repro_torch/`, the autograd node in a backward)
where the reference prints the HLO computation.
"""
import argparse
import json

import torch.distributed as dist


def main(argv=None):
    from repro_torch.configs import EMBEDDING_ARCHS
    from repro_torch.launch import hlo_cost
    from repro_torch.launch.dryrun import (_fake_group, lower_cell,
                                           lower_embedding_cell)
    from repro_torch.launch.mesh import make_production_mesh, n_chips

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--overrides", default=None)
    a = ap.parse_args(argv)
    overrides = json.loads(a.overrides) if a.overrides else None

    _fake_group(512 if a.mesh == "multi" else 256)
    try:
        mesh = make_production_mesh(multi_pod=(a.mesh == "multi"))
        if a.arch in EMBEDDING_ARCHS:
            cell, mflops = lower_embedding_cell(a.arch, mesh, overrides)
        else:
            cell, mflops = lower_cell(a.arch, a.shape, mesh, overrides)
        counted = cell.count()
    finally:
        dist.destroy_process_group()
    c, chips = counted.cost, n_chips(mesh)
    print(f"total flops/chip {c.flops:.3e}  bytes/chip {c.bytes:.3e}  "
          f"coll/chip {sum(c.collective_bytes.values()):.3e}"
          + (f"  (fitted over {counted.fitted})" if counted.fitted else ""))
    print(f"MODEL_FLOPS {mflops:.3e}  chips {chips}  "
          f"ratio {mflops / (c.flops * chips + 1e-30):.3f}")
    print(f"{'summed flops':>15s}  {'where':60s} {'out':40s} op")
    for f, where, shape, op in hlo_cost.top_flops(counted.matmuls, a.top):
        print(f"{f:15.3e}  {where:60s} {shape:40s} {op}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
