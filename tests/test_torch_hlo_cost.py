"""The port's op-stream counter (repro_torch.launch.hlo_cost) against known
costs: the reference's own programs of tests/test_hlo_cost.py and
tests/test_roofline.py:45-78, counted from the ops the port dispatches (on
`meta` tensors: shapes only) instead of from HLO text.

  * a 128x256 @ 256x64 matmul counts 2 * 128 * 256 * 64 FLOPs exactly;
  * a Python loop of L layers counts L times one layer, nested loops
    multiply;
  * views move no bytes, nor does an op that returns its input's storage
    without writing it (`_unsafe_view`, after `einsum`'s `clone`: the
    clone counts, the view not); a slice write moves its update's;
  * the live-bytes peak of a known program is exact, a softmax kernel's
    copy of a non-contiguous operand in it;
  * on rank 0 of a fake process group of 8 ranks, an all-gather of an
    f32[16, 512] block counts 16 * 512 * 4 bytes under all-gather and an
    all-reduce as much under all-reduce (tests/test_roofline.py:45-60);
    an unmapped c10d op raises;
  * the fitted counts (`fit_cost`) equal the direct counts exactly (FLOPs,
    bytes, collective bytes; memory within 5%) for the qwen2-7b,
    grok-1-314b and rwkv6-7b smoke configs on a (2, 4) fake mesh, at G, M
    (and S for rwkv6) beyond the fit's points;
  * the smoke prefills' matmul FLOPs against JAX's `hlo_cost.top_flops`.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import batch_specs as jbatch_specs
from repro.launch import hlo_cost as jhlo_cost
from repro.models import build_model as jbuild_model
from repro.models import make_prefill as jmake_prefill
from repro.models import params_specs as jparams_specs
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import batch_specs
from repro_torch.launch.hlo_cost import (COLLECTIVES, Cost, CostCounter,
                                         Counted, count, fit_cost, top_flops)
from repro_torch.models import (block_pattern, build_model, make_prefill,
                                params_specs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_plain_matmul_flops_exact():
    _, c = count(lambda a, b: a @ b, _meta(128, 256), _meta(256, 64))
    assert c.cost.flops == 2 * 128 * 256 * 64
    assert c.cost.bytes == (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_loop_multiplies_flops():
    """An L-layer Python loop costs L x one layer: the matmul and its tanh
    (one FLOP an f32 output element)."""
    L, B, D = 8, 16, 128

    def f(ws, x):
        for layer in range(L):
            x = torch.tanh(x @ ws[layer])
        return x

    _, c = count(f, _meta(L, D, D), _meta(B, D))
    assert c.cost.flops == L * (2 * B * D * D + B * D)
    # each layer reads its weight slice once, not the whole stack
    assert c.cost.bytes == L * (D * D + 4 * B * D) * 4


def test_nested_loops_multiply():
    L1, L2, B, D = 4, 6, 8, 64

    def f(ws, x):
        for i in range(L1):
            for j in range(L2):
                x = x @ ws[i, j]
        return x

    _, c = count(f, _meta(L1, L2, D, D), _meta(B, D))
    assert c.cost.flops == L1 * L2 * 2 * B * D * D


def test_views_move_no_bytes():
    x = _meta(16, 128)

    def f(x):
        y = x.view(-1).reshape(4, -1).t().unsqueeze(0).expand(3, -1, -1)
        return y[1:, :2].permute(2, 0, 1).transpose(0, 1).squeeze().detach()

    out, c = count(f, x)
    assert c.n_ops > 5
    assert c.cost.flops == 0 and c.cost.bytes == 0
    assert c.memory["temp_size_in_bytes"] == 0


def test_einsum_clone_counts_the_clone_and_no_more():
    """An `einsum` whose batch dims cannot be merged by a view clones its
    first operand before the `bmm`, then `_unsafe_view`s the copy: the
    clone moves its operand twice (read, write), the `bmm` its operands and
    output, and the `_unsafe_view`, which shares the clone's storage,
    nothing."""
    a = _meta(3, 2, 5, 6).transpose(0, 1)           # (b, h) = (2, 3) strided
    b = _meta(2, 3, 6, 4)
    with CostCounter() as cc:
        torch.einsum("bhij,bhjk->bhik", a, b)
    ops = {r.op: r.bytes for r in cc.records}
    assert "aten.clone.default" in ops and "aten._unsafe_view.default" in ops
    clone = 2 * 2 * 3 * 5 * 6 * 4
    bmm = (6 * 5 * 6 + 6 * 6 * 4 + 6 * 5 * 4) * 4
    assert ops["aten.clone.default"] == clone
    assert ops["aten._unsafe_view.default"] == 0
    assert cc.cost.bytes == clone + bmm


def test_an_op_that_aliases_its_input_moves_nothing():
    """`_unsafe_view` is no view by its schema (`func.is_view` is False), but
    its output shares its input's storage: 0 bytes, 0 FLOPs; an in-place op,
    whose output shares its written input's storage, still counts."""
    x = _meta(6, 4)
    _, c = count(lambda x: torch.ops.aten._unsafe_view(x, [24]), x)
    assert not torch.ops.aten._unsafe_view.default.is_view
    assert c.n_ops == 1 and c.cost.bytes == 0 and c.cost.flops == 0
    _, c = count(lambda x: x.mul_(2.0), torch.zeros(6, 4))
    assert c.cost.bytes == 2 * 6 * 4 * 4


def test_slice_write_counts_the_update():
    """The reference's dynamic-update-slice rule: a write into part of a
    buffer in place moves the update (read) and the slice (written), not
    the buffer; `index_copy_` reads the index and the update."""
    def write(buf, upd):
        buf[8:16] = upd
        return buf

    _, c = count(write, torch.zeros(64, 32), torch.ones(8, 32))
    assert c.cost.bytes == 2 * 8 * 32 * 4
    assert c.memory["alias_size_in_bytes"] == 64 * 32 * 4
    idx = torch.empty(1, dtype=torch.long, device="meta")
    _, c = count(lambda buf, upd: buf.index_copy_(0, idx, upd),
                 _meta(64, 32), _meta(1, 32))
    assert c.cost.bytes == 8 + 2 * 32 * 4


@pytest.mark.parametrize("op", ["index_copy", "index_put"])
def test_out_of_place_index_write_counts_the_whole_buffer(op):
    """The out-of-place forms (a decode step's cache write) read the whole
    source buffer, the index and the update and write a whole new buffer,
    as the card runs them; they are not the in-place update."""
    idx = torch.zeros(1, dtype=torch.long)
    if op == "index_copy":
        def fn(buf, upd):
            return buf.index_copy(0, idx, upd)
    else:
        def fn(buf, upd):
            return buf.index_put((idx,), upd)
    _, c = count(fn, torch.zeros(64, 32), torch.ones(1, 32))
    assert c.cost.bytes == 2 * 64 * 32 * 4 + 8 + 32 * 4


def test_live_bytes_peak_exact():
    """The peak of the live storages the call creates: two (16, 128) f32
    temporaries at once, never three; views add nothing."""
    B, D = 16, 128

    def f(x):
        a = x * 2
        b = (a + 1).view(-1)
        del a
        return b * b

    x = _meta(B, D)
    with CostCounter() as cc:
        out = f(x)
    assert cc.peak_bytes == 2 * B * D * 4
    assert cc.live_bytes == B * D * 4          # the output alone
    del out
    assert cc.live_bytes == 0


def test_a_kernels_contiguous_copy_counts_towards_the_peak():
    """The softmax kernels copy a non-contiguous operand into a contiguous
    buffer for the op's duration: the peak holds the output and the copy;
    a contiguous operand needs none.  Neither moves a counted byte."""
    x = _meta(64, 32)
    with CostCounter() as cc:
        torch.softmax(x.t(), dim=-1)
    assert cc.peak_bytes == 2 * 64 * 32 * 4
    with CostCounter() as cc:
        torch.softmax(x, dim=-1)
    assert cc.peak_bytes == 64 * 32 * 4


def test_backward_and_remat_are_counted():
    """The backward's matmuls (two a forward matmul) and remat's recompute
    run below autograd and are counted; backward ops name their node."""
    x = torch.empty(8, 32, device="meta", requires_grad=True)
    w = torch.empty(32, 32, device="meta", requires_grad=True)
    plain = 2 * 8 * 32 * 32

    def step(x, w):
        y = torch.utils.checkpoint.checkpoint(
            lambda x: torch.tanh(x @ w), x, use_reentrant=False)
        y.sum().backward()

    with CostCounter() as cc:
        step(x, w)
    mm = [r for r in cc.records if r.op == "aten.mm.default"]
    assert sum(r.flops for r in mm) == 4 * plain    # forward, recompute, 2
    assert sum("MmBackward0" in r.where for r in mm) == 2
    assert any("test_torch_hlo_cost" not in r.where and r.where for r in mm)


def test_top_flops_sums_repeats_by_location():
    def f(ws, x):
        for layer in range(3):
            x = x @ ws[layer]
        return x @ ws[0][:, :8]

    with CostCounter() as cc:
        f(_meta(3, 64, 64), _meta(4, 64))
    rows = top_flops(cc.records)
    assert [r[0] for r in rows] == [3 * 2 * 4 * 64 * 64, 2 * 4 * 64 * 8]
    assert all(r[3] == "aten.mm.default" for r in rows)


def test_fit_cost_is_an_exact_lagrange_fit():
    """A cost polynomial of degree 2 in g and 1 in m, fitted from g in {1,
    2, 3} and m in {2, 3}, is exact at (9, 8), and so are the memory's
    sizes; the peak is extended to first order from the largest point (g
    = 3, m = 3), past g = 1's kink and with no cross term."""
    def count_at(v):
        g, m = v["g"], v["m"]
        flops = 7 * g * g * m + 3 * g + 0.25 * m + 11
        return Counted(Cost(flops, 2.0 * flops,
                            {k: float(g * m) for k in COLLECTIVES}),
                       {"temp_size_in_bytes": 100 * g + 5 * (g == 1)
                        + g * m, "argument_size_in_bytes": 10 * g * m + 3},
                       {("here", "[2, 2]", "aten.mm.default"): 8.0 * g * m},
                       n_ops=g * m + 1)

    got = fit_cost(count_at, {"g": 9, "m": 8}, {"g": (1, 2, 3),
                                               "m": (2, 3)})
    want = count_at({"g": 9, "m": 8})
    assert got.cost == want.cost and got.n_ops == want.n_ops
    assert got.matmuls == want.matmuls
    assert got.memory == {"temp_size_in_bytes": 900 + 9 + 6 * 3 + 5 * 3,
                          "argument_size_in_bytes": 723, "estimate": True}
    assert got.fitted == {"g": [1, 2, 3], "m": [2, 3]}


# -- on a fake process group ------------------------------------------------------

_FAKE_GROUP = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun, hlo_cost
    from repro_torch.launch.mesh import Mesh
    dryrun._fake_group(8)
    mesh = Mesh({"data": 2, "model": 4})
    out = {}
""")

_COLLECTIVES = textwrap.dedent("""
    block = torch.empty((16, 512), device="meta")
    parts = [torch.empty_like(block) for _ in range(8)]
    with hlo_cost.CostCounter() as cc:
        dist.all_gather(parts, block)
        dist.all_reduce(block)
    out["counted"] = cc.cost.collective_bytes
    try:
        with hlo_cost.CostCounter():
            dist.broadcast(block, src=0)
        out["unmapped"] = "counted"
    except NotImplementedError as e:
        out["unmapped"] = str(e)
""")

_FITS = _FAKE_GROUP + _COLLECTIVES + textwrap.dedent("""
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    for arch, groups, nmb, seq in json.loads(sys.argv[1]):
        cfg = get_smoke_config(arch)
        cases = [("train", RunConfig(num_microbatches=nmb, remat="full"))]
        if arch == "qwen2-7b":
            cases.append(("prefill", RunConfig()))
        for mode, run in cases:
            pattern = len(dryrun.block_pattern(cfg)[0])
            c = dataclasses.replace(cfg, num_layers=groups * pattern)
            cell = dryrun._lm_cell(c, ShapeConfig(mode, mode, seq, 8), run,
                                   mesh)
            plan = {d: p for d, p in cell.grid.items()
                    if p[-1] < cell.at[d]}
            direct = cell.count_at(cell.at)
            fitted = hlo_cost.fit_cost(cell.count_at, cell.at, plan,
                                       matmul_shapes="seq" not in plan)
            out[f"{arch}/{mode}"] = {
                k: {"cost": dataclasses.asdict(x.cost), "memory": x.memory,
                    "n_ops": x.n_ops, "matmuls": sum(x.matmuls.values()),
                    "fitted": x.fitted}
                for k, x in (("direct", direct), ("fitted", fitted))}
    print(json.dumps(out))
""")
#: (arch, G, M, S): beyond the fit's points (G above 3, train's degree-2
#: fit; M above 3; S above rwkv6's time-loop points 2, 3, 4)
FIT_CASES = (("qwen2-7b", 4, 4, 16), ("grok-1-314b", 4, 4, 16),
             ("rwkv6-7b", 4, 1, 32))


def _run(prog: str, *args: str) -> dict:
    """Runs `prog` in a fresh interpreter (a fake group is per process)
    and returns the JSON of its last line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", prog, *args], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fits():
    return _run(_FITS, json.dumps(FIT_CASES))


def test_collective_bytes_on_a_fake_group(fits):
    out = fits
    want = {k: 0.0 for k in COLLECTIVES}
    want["all-gather"] = want["all-reduce"] = 16 * 512 * 4
    assert out["counted"] == want
    assert "'broadcast_'" in out["unmapped"], out["unmapped"]


@pytest.mark.parametrize("arch", [c[0] for c in FIT_CASES])
def test_fitted_counts_equal_direct_counts(fits, arch):
    """The smoke configs' own G (2-3), M and S lie among the fit's points,
    so each is counted at FIT_CASES' G, M and S, beyond them (rwkv6, a
    Python time loop, fitted in the loop's trip count T = S too, from 2,
    3 and 4 steps).  FLOPs, bytes, collective bytes,
    the op count and the matmuls' FLOPs exactly; the memory (argument +
    temp) within 5%; qwen2-7b's prefill (degree 1 in G) as well."""
    modes = [k.split("/")[1] for k in fits if k.startswith(arch + "/")]
    assert modes == (["train", "prefill"] if arch == "qwen2-7b"
                     else ["train"])
    for mode in modes:
        d, f = fits[f"{arch}/{mode}"]["direct"], fits[f"{arch}/{mode}"][
            "fitted"]
        assert f["fitted"]["groups"] == [1, 2, 3]
        assert f["fitted"].get("microbatches") == (
            [2, 3] if mode == "train" and arch != "rwkv6-7b" else None)
        assert f["fitted"].get("loop") == (
            [2, 3, 4] if arch == "rwkv6-7b" else None)
        assert "seq" not in f["fitted"]
        assert d["cost"] == f["cost"], mode
        assert d["n_ops"] == f["n_ops"] and d["matmuls"] == f["matmuls"]
        # both are the sharded program: the prefill all-reduces too
        assert d["cost"]["collective_bytes"]["all-reduce"] > 0, mode

        def peak(m):
            return m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
        assert abs(peak(f["memory"]) / peak(d["memory"]) - 1) <= 0.05, mode


# -- against JAX's HLO count ------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-7b", "grok-1-314b", "rwkv6-7b",
                                  "zamba2-2.7b", "llama-3.2-vision-90b"])
def test_prefill_matmul_flops_against_jax(arch):
    """The smoke prefill (B = 4, S = 64): the port's matmul FLOPs minus
    JAX's (`hlo_cost.top_flops` summed over every dot of the compiled
    prefill) are exactly 2 B S D V, the LM head over every position: both
    packages compute the head over all S positions and keep the last
    (src/repro_torch/models/model.py `prefill`, src/repro/models/model.py
    `prefill`), XLA simplifies the dot and the slice to the last position,
    and the eager port computes the whole head; less, for a MoE model, the
    reference's two dispatch einsums over the (B, S, k, E, C) one-hot, 2 B
    S k E C each a layer, which the port builds elementwise from each
    (token, expert) pair's one slot (`moe._dispatch_combine`)."""
    B, S = 4, 64
    jcfg = jget_smoke_config(arch)
    jmodel = jbuild_model(jcfg, JRunConfig())
    text = jax.jit(jmake_prefill(jmodel)).lower(
        jparams_specs(jmodel)[0],
        jbatch_specs(jcfg, JShapeConfig("p", "prefill", S, B))
    ).compile().as_text()
    jax_flops = sum(r[0] for r in jhlo_cost.top_flops(text, 1 << 30))

    cfg = get_smoke_config(arch)
    model = build_model(cfg, RunConfig())
    with torch.no_grad():
        _, c = count(make_prefill(model), params_specs(model)[0],
                     batch_specs(cfg, ShapeConfig("p", "prefill", S, B)))
    port_flops = sum(c.matmuls.values())
    dispatch = 0
    if cfg.num_experts:
        from repro_torch.models.moe import _capacity
        pattern, groups = block_pattern(cfg)
        layers = pattern.count("moe") * groups
        dispatch = layers * 2 * (2 * B * S * cfg.experts_per_token
                                 * cfg.num_experts * _capacity(S, cfg))
    assert port_flops - jax_flops == (2 * B * S * cfg.d_model
                                      * cfg.vocab_size - dispatch)
