"""The port's dry run (repro_torch.launch.dryrun, profile_cell): the
counterpart of tests/test_dryrun_smoke.py.

In a subprocess, rank 0 of a fake process group of 8 ranks on a (2, 4)
("data", "model") mesh counts the train and decode cells of the smoke
configs on `meta` (`ARCHS`, `SERVE_ARCHS`):

  * FLOPs a chip > 0, finite terms, the memory keys present;
  * train: each collective kind's bytes are `train_collective_bytes`',
    the sharded step's identities from the params' specs and the loop
    counts (a group's FSDP gathers in the forward and remat's recompute,
    their reduce-scatters, the "model" all-reduces a layer, the
    vocab-parallel embedding and loss); the all-gather and the
    reduce-scatter move blocks, never a whole split leaf;
  * prefill and decode: each kind's bytes are `serve_collective_bytes`',
    the sharded serving program's, for every family (rwkv6's and zamba2's
    on a rank's SSM heads among them);
  * rwkv6's and zamba2's train and prefill cells with their time loops
    fitted in the trip count from 2, 3 and 4 steps equal the direct
    count of 24 steps;
  * an embedding cell at the smoke N: MODEL_FLOPS is the reference's
    6 N^2 (d + 4), the all-reduce bytes the layout's (N/R, 2d) block plus
    its two scalars;
  * the dry run refuses a process with a real process group.

Then on a fake group of 256 ranks (the production mesh): a row's keys are
the reference's `run_cell` row's plus `fitted`, `existing_keys` skips done
rows, and `main` / `profile_cell.main` print their reports.  In a process
of its own, rank 0's share of qwen2-7b train_4k on the single mesh: no op
of the step makes a tensor of a whole stacked leaf's shape, or of the
whole shape of a leaf split over "model", and the counted rank peak is
below the card's 80 GB and below PR 25's 91.7 GB by at least its 60.9 GB of
whole params and whole gradient.  In a third
process of its own (JAX's dryrun module forces 512 host devices when it
is imported): `default_run_config` equals JAX's for every shape.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro_torch.configs import SHAPES
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the train cells' archs: the dense, MoE (grok's experts and llama4's
#: experts and shared expert over "model") and SSM families, and the vision
#: cross-attention on "model" blocks
ARCHS = ("qwen2-7b", "grok-1-314b", "rwkv6-7b", "llama4-maverick-400b-a17b",
         "llama-3.2-vision-90b", "zamba2-2.7b")
#: the serving cells' archs: every family, the vision cross-attention and
#: the audio codebooks too
SERVE_ARCHS = ARCHS + ("musicgen-medium",)
#: the archs with SSM time loops, whose loops the fitted cells count at a
#: few trip counts (`dryrun.LOOP_POINTS`)
LOOP_ARCHS = ("rwkv6-7b", "zamba2-2.7b")

_PROG = textwrap.dedent("""
    import contextlib, dataclasses, datetime, io, json, math, os, sys
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, profile_cell
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import Mesh

    out = {}
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        dryrun._fake_group(8)
        out["refused"] = ""
    except RuntimeError as e:
        out["refused"] = str(e)
    dist.destroy_process_group()

    dryrun._fake_group(8)
    mesh = Mesh({"data": 2, "model": 4})

    def row(counted, mflops):
        r = rl.analyze(counted.cost, mesh.size, mflops).as_dict()
        return dict(r, memory=counted.memory, fitted=counted.fitted)

    for arch in sys.argv[1].split(","):
        cfg = get_smoke_config(arch)
        run = RunConfig(num_microbatches=2, remat="full")
        shape = ShapeConfig("t", "train", 16, 16)
        cell = dryrun._lm_cell(cfg, shape, run, mesh)
        out[arch, "train"] = dict(
            row(cell.count(), rl.model_flops_for(cfg, shape)),
            want=dryrun.train_collective_bytes(cfg, run, mesh, 16, 16))
    for arch in sys.argv[2].split(","):
        cfg = get_smoke_config(arch)
        for mode, name in (("decode", "decode_32k"),
                           ("prefill", "prefill_32k")):
            run = dryrun.default_run_config(name)
            shape = ShapeConfig(mode[0], mode, 16, 8)
            cell = dryrun._lm_cell(cfg, shape, run, mesh)
            out[arch, mode] = dict(
                row(cell.count(), rl.model_flops_for(cfg, shape)),
                want=dryrun.serve_collective_bytes(cfg, run, mesh, 8, 16,
                                                   mode))

    # the SSM time loops fitted in their trip count against a direct count
    from repro_torch.launch import hlo_cost
    for arch in sys.argv[3].split(","):
        cfg = get_smoke_config(arch)
        for mode, run in (("train", RunConfig(num_microbatches=2,
                                              remat="full")),
                          ("prefill",
                           dryrun.default_run_config("prefill_32k"))):
            cell = dryrun._lm_cell(cfg, ShapeConfig(mode[0], mode, 24, 16),
                                   run, mesh)
            got = [cell.count_at(cell.at), hlo_cost.fit_cost(
                cell.count_at, cell.at, {"loop": dryrun.LOOP_POINTS})]
            out[arch, mode, "loop"] = [dict(
                flops=c.cost.flops, bytes=c.cost.bytes, ops=c.n_ops,
                coll=c.cost.collective_bytes, fitted=c.fitted,
                memory={k: v for k, v in c.memory.items()
                        if k != "estimate"}) for c in got]

    ecfg = get_smoke_config("embedding-coil20")
    cell, mflops = dryrun._embedding_cell(ecfg, mesh)
    out["embedding", ecfg.n_points] = dict(row(cell.count(), mflops),
                                           d=ecfg.embed_dim)

    # the production mesh: a row, the skips, the two commands
    path = os.path.join(tmp, "rows.jsonl")
    out["row"] = dryrun.run_cell("embedding-coil20", None, "single", path,
                                 verbose=False)
    done = dryrun.existing_keys(path)
    with open(path, "a") as f:
        f.write("not json\\n")
        for arch in dryrun.ARCH_IDS:
            for sc in dryrun.shape_cells(arch):
                f.write(json.dumps({"arch": arch, "shape": sc.name,
                                    "mesh": "single"}) + "\\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dryrun.main(["--all", "--out", path])
        dryrun.main(["--arch", "embedding-coil20", "--out", path])
        profile_cell.main(["--arch", "embedding-coil20", "--top", "3"])
    out["done"] = sorted(done)
    out["keys"] = len(dryrun.existing_keys(path))
    out["printed"] = buf.getvalue()
    print(json.dumps({"/".join(map(str, k)) if isinstance(k, tuple) else k:
                      v for k, v in out.items()}))
""")


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROG, ",".join(ARCHS),
                           ",".join(SERVE_ARCHS), ",".join(LOOP_ARCHS)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _finite_row(r):
    assert r["flops_per_chip"] > 0
    for k in ("compute_s", "memory_s", "collective_s", "useful_ratio"):
        assert 0 <= r[k] < float("inf"), k
    assert set(r["memory"]) >= {"argument_size_in_bytes",
                                "output_size_in_bytes", "temp_size_in_bytes",
                                "alias_size_in_bytes"}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell(counted, arch):
    r = counted[f"{arch}/train"]
    _finite_row(r)
    assert r["fitted"] is None                  # smoke: counted directly
    got = r["collectives"]
    for kind, want in r["want"].items():
        assert got[kind] == want > 0, kind
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert r["memory"]["alias_size_in_bytes"] > 0     # the state, in place


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cell_has_no_collective(counted, arch):
    """A decode cell's collectives are the sharded decode step's and
    nothing else: each kind's bytes are `serve_collective_bytes`' (no
    all-to-all or permute, and no reduce-scatter: the step is forward only,
    bar RWKV6's channel mix, which reduce-scatters its partial product
    onto a rank's heads' columns in the forward)."""
    _serve_cell(counted[f"{arch}/decode"], arch)


def _serve_cell(r, arch):
    _finite_row(r)
    got = r["collectives"]
    for kind, want in r["want"].items():
        assert got[kind] == want, kind
    assert got["all-gather"] > 0
    assert (got["reduce-scatter"] > 0) == (arch == "rwkv6-7b")
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert r["memory"]["alias_size_in_bytes"] == 0    # nothing in place


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_cell_collectives(counted, arch, mode):
    """The sharded prefill and decode cells on the (2, 4) mesh: each
    collective kind's bytes are `serve_collective_bytes`', from the
    params' and caches' specs and the loop counts (a group's FSDP gathers,
    q, k and v gathered where their heads do not divide, the row-parallel
    all-reduces, the vocab-parallel embedding and the head's last
    position, a decode step's softmax combined over the split slots)."""
    _serve_cell(counted[f"{arch}/{mode}"], arch)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", LOOP_ARCHS)
def test_time_loop_fit_is_the_direct_count(counted, arch, mode):
    """A cell whose SSM time loops run 2, 3 and 4 of their 24 steps
    (`hooks.time_loop_limit`), fitted in the trip count, is the direct
    count of the 24 steps: the same FLOPs, bytes, collective bytes, ops
    and memory summary (its peak too, at these shapes); a step of the loop
    dispatches the same ops at every step."""
    direct, fit = counted[f"{arch}/{mode}/loop"]
    assert direct["fitted"] is None and fit["fitted"] == {"loop": [2, 3, 4]}
    for k in ("flops", "bytes", "ops", "coll", "memory"):
        assert fit[k] == direct[k], k


def test_time_loop_limit_is_for_meta_alone():
    """The counting device refuses a real tensor: a cut loop computes
    nothing for the steps it skips."""
    import torch

    from repro_torch.models import hooks

    with hooks.time_loop_limit(2):
        assert hooks.time_steps(9, "meta") == 2
        assert hooks.time_steps(1, "meta") == 1
        with pytest.raises(ValueError, match="meta"):
            hooks.time_steps(9, torch.device("cpu"))
    assert hooks.time_steps(9, "cpu") == 9
    with pytest.raises(ValueError):
        with hooks.time_loop_limit(0):
            pass


def test_embedding_cell(counted):
    (key,) = [k for k in counted if k.startswith("embedding/")]
    n = int(key.split("/")[1])
    r = counted[key]
    _finite_row(r)
    assert r["model_flops"] == 6.0 * n * n * (r["d"] + 4)
    # (N/R, 2d) f32 over the row, (e_plus, s) over every rank; R = 2
    assert r["collectives"]["all-reduce"] == (n // 2) * 2 * r["d"] * 4 + 8
    assert r["collectives"]["all-gather"] == 0


def test_refuses_a_real_process_group(counted):
    assert "fake process group" in counted["refused"]
    assert "'gloo'" in counted["refused"]


def test_row_keys_are_the_references(counted):
    """The reference's run_cell row: arch, shape, mesh, tag, chips,
    lower_s, compile_s, memory and the Roofline's fields; the port adds
    `fitted`."""
    ref = {"arch", "shape", "mesh", "tag", "chips", "lower_s", "compile_s",
           "memory"} | set(jrl.Roofline.__dataclass_fields__)
    row = counted["row"]
    assert set(row) == ref | {"fitted"}
    assert row["chips"] == 256 and row["mesh"] == "single"
    assert row["collectives"]["all-reduce"] > 0


def test_existing_keys_skip_done_rows(counted):
    assert counted["done"] == [["embedding-coil20", None, "single",
                                "baseline"]]
    printed = counted["printed"]
    n_cells = sum(len(dryrun.shape_cells(a)) for a in dryrun.ARCH_IDS)
    assert printed.count("skip ") == n_cells
    assert "FAILED" not in printed and "SKIP-CELL" in printed
    assert counted["keys"] == n_cells + 1
    assert "== embedding-coil20 x None x single [baseline] ==" in printed
    assert "MODEL_FLOPS" in printed and "summed flops" in printed


_SHARE = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from repro_torch.launch import dryrun, hlo_cost
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import state_shardings
    from repro_torch.models import hooks
    from repro_torch.distributed.sharding import make_activation_constraint
    from repro_torch.tree import leaves

    dryrun._fake_group(256)
    mesh = make_production_mesh()
    cell, _ = dryrun.lower_cell("qwen2-7b", "train_4k", mesh)
    step, (state, batch) = cell.prepare(cell.at)
    hooks.set_activation_constraint(make_activation_constraint(mesh,
                                                               cell.run))
    with hlo_cost.CostCounter() as cc:
        out = step(state, batch)
    mem = hlo_cost.memory_summary(cc, (state, batch), out)
    made = {r.out_shapes for r in cc.records}
    made = {s for shapes in made for s in shapes}
    # the whole shapes no op may make: a stacked leaf's, and a layer's (or
    # an unstacked leaf's) where its spec splits it over "model"; a shape
    # that an FSDP gather makes whole by design (a layer's norm) is not
    from repro_torch.models import build_model, train_state_specs
    specs, axes = train_state_specs(build_model(
        dryrun.get_config("qwen2-7b"), cell.run))
    sh = state_shardings(mesh, axes, specs)
    banned, allowed = set(), set()
    for key in specs["params"]:
        stacked = key == "slots"
        for s, p in zip(leaves(sh["params"][key]),
                        leaves(specs["params"][key])):
            shape = tuple(p.shape)
            one = shape[1:] if stacked else shape
            if "model" in s.axes:
                banned.add(one)
            else:
                allowed.add(one)
            if stacked and not s.is_whole:
                banned.add(shape)
    banned -= allowed
    print(json.dumps({"memory": mem, "made": sorted(made & banned),
                      "banned": len(banned), "ops": cc.n_ops}))
    dist.destroy_process_group()
""")


def test_no_rank_materialises_a_whole_split_leaf():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _SHARE], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["banned"] > 0 and got["made"] == []
    mem = got["memory"]
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    # PR 25's count of the data-parallel step: 91.7 GB, of which 60.9 GB
    # were the whole f32 params and the whole f32 gradient
    assert peak < 80e9 and peak <= 91.7e9 - 60.9e9


_SERVE_SHARE = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (make_activation_constraint,
                                                  tree_shardings)
    from repro_torch.launch import dryrun, hlo_cost
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model, hooks
    from repro_torch.tree import leaves

    arch, cell_name = sys.argv[1], sys.argv[2]
    dryrun._fake_group(256)
    mesh = make_production_mesh()
    cell, _ = dryrun.lower_cell(arch, cell_name, mesh)
    fn, args = cell.prepare(cell.at)
    hooks.set_activation_constraint(make_activation_constraint(mesh,
                                                               cell.run))
    with hlo_cost.CostCounter() as cc:
        out = fn(*args)
    mem = hlo_cost.memory_summary(cc, args, out)
    made = {s for r in cc.records for s in r.out_shapes}
    # the whole shapes of the leaves that the specs split over "model",
    # stacked and a layer's: no op may make one (a shape that a leaf whole
    # on "model" has is not banned, nor a layer's router: every rank
    # routes from the whole router, gathered over "model")
    specs, axes = dryrun._serve_specs(build_model(dryrun.get_config(arch),
                                                  cell.run))
    sh = tree_shardings(mesh, axes, specs)
    banned, allowed = set(), set()
    for key in specs:
        stacked = key == "slots"
        for s, p in zip(leaves(sh[key]), leaves(specs[key])):
            shape = tuple(p.shape)
            one = shape[1:] if stacked else shape
            (banned if "model" in s.axes else allowed).add(one)
            if stacked and not s.is_whole:
                banned.add(shape)
    for slot in specs["slots"]:
        if "router" in slot.get("ffn", {}):
            allowed.add(tuple(slot["ffn"]["router"].shape[1:]))
    banned -= allowed
    experts = {tuple(p.shape[1:]) for p in
               leaves(specs["slots"][1]["ffn"]) if p.ndim == 4}
    print(json.dumps({"memory": mem, "made": sorted(made & banned),
                      "experts": sorted(experts), "banned": sorted(banned),
                      "collectives": cc.cost.collective_bytes,
                      "want": dryrun.serve_collective_bytes(
                          dryrun.get_config(arch), cell.run, mesh,
                          dryrun.SHAPES[cell_name].global_batch,
                          dryrun.SHAPES[cell_name].seq_len,
                          dryrun.SHAPES[cell_name].mode)}))
    dist.destroy_process_group()
""")


def test_llama4_decode_share_holds_no_whole_expert():
    """Rank 0's share of llama4-maverick decode_32k on the single (16, 16)
    mesh, on `meta`: its 128 experts a MoE layer are 8-expert blocks over
    "model" (expert parallelism), so no op makes a tensor of a whole
    expert leaf's shape (128, 5120, 8192) or of any leaf the specs split
    over "model"; the counted peak is below the card's 80 GB (88.4 GB
    counted with the experts gathered whole); the collectives are
    `serve_collective_bytes`' (the experts' all-reduce and the pooled
    routing's all-gather of top-k indices over the FSDP axes)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _SERVE_SHARE,
                           "llama4-maverick-400b-a17b", "decode_32k"],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [128, 5120, 8192] in got["banned"] and got["made"] == []
    assert got["experts"] == [[128, 5120, 8192], [128, 8192, 5120]]
    mem = got["memory"]
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert peak < 80e9
    for kind, want in got["want"].items():
        assert got["collectives"][kind] == want, kind


#: `repro/launch/dryrun.py` forces 512 host devices when it is imported,
#: so JAX's `default_run_config` is read in a process of its own
_JAX_RUN_CONFIGS = textwrap.dedent("""
    import dataclasses, json
    from repro.configs import SHAPES
    from repro.launch.dryrun import default_run_config
    print(json.dumps({f"{name}/{i}": dataclasses.asdict(
        default_run_config(name, ov)) for name in SHAPES
        for i, ov in enumerate((None, {"num_microbatches": 16,
                                       "attn_q_chunk": 512}))}))
""")


def test_default_run_config_matches_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_RUN_CONFIGS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(SHAPES) == set(JSHAPES)
    for name in SHAPES:
        for i, ov in enumerate((None, {"num_microbatches": 16,
                                       "attn_q_chunk": 512})):
            got = dataclasses.asdict(dryrun.default_run_config(name, ov))
            assert got == want[f"{name}/{i}"], name
