"""The port's row-sharded sparse backend against the JAX reference.

On jax 0.9 every JAX sharded test fails (ROADMAP.md, "Reference caveats"),
so the port's sharded functions are held against what those tests compare
with: JAX's single-device `energy_and_grad_sparse`, `make_sd_operator` and
sparse fit, at the reference's sharded bounds.  The port runs in 1, 2 and 4
gloo ranks on the CPU, spawned by tests/test_torch_sharding_ranks.py (which
imports no JAX) with JAX's graphs, starts and draws handed over as numpy.
One spawn a world size runs every check of that size; each check is a test
of its own over the spawn's results.

Tolerances: the local-rows product at rtol 5e-5 / atol 5e-5 against JAX's
local-rows kernel in interpret mode (tests/test_sparse_kernel.py:152-167);
sharded E, G and z within 1e-5 relative of the single-device ones
(tests/test_sharded_sparse.py:51,70); the SD operator's matvec at rtol 1e-5
/ atol 1e-6 with inv_diag and mu exactly equal to the single-device
operator's (tests/test_sharded_sparse.py:280-289); whole fits at rtol 1e-4 with equal
PCG counts at mu_scale = 1e-3 and at rtol 5e-3 at the default
(tests/test_sharded_sparse.py:136,144; the near-singular SD system,
tests/test_torch_sparse.py MU_SCALE).

Each spawn waits at most SPAWN_TIMEOUT_S, and each collective at most
GROUP_TIMEOUT_S, so a deadlock fails its test instead of stalling the run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sharding_ranks as worker
from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.api.backends import fit_sparse_sharded as jfit_sparse_sharded
from repro.api.registries import resolve_backend as jresolve_backend
from repro.core import energy_and_grad_sparse as jeg_sparse
from repro.embed.trainer import _sparse_spectral_init as jspectral_init
from repro.kernels import ops as jops
from repro.kernels.ref import ell_lap_matvec_ref as jell_ref
from repro.sparse import make_sd_operator as jsd_operator
from repro.sparse import sparse_affinities as jsparse_affinities
from repro.sparse import validate_sparse_mesh as jvalidate_sparse_mesh
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec, resolve_backend
from repro_torch.api.backends import fit_sparse_sharded
from repro_torch.embed.trainer import build_sparse_objective
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ell_lap_matvec_local_ref
from repro_torch.sparse import validate_sparse_mesh
from tests.conftest import three_loops

WORLDS = (1, 2, 4)
EG_CASES = [("ee", 50.0), ("tsne", 2.0), ("tee", 10.0)]
FITS = [("ee", 50.0), ("tsne", 1.0)]
FIT_ITERS = 5
N_NEG = 5


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _arrays(saff):
    return tuple(np.asarray(a) for a in (saff.graph.indices,
                                          saff.graph.weights,
                                          saff.rev.indices, saff.rev.weights))


def _jax_shifts(seed, it, n, m):
    """The reference's draw of iteration `it` under the engine's
    fold_in(PRNGKey(seed), it) (core/objectives.py:268)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    return np.asarray(1 + jax.random.choice(key, n - 1, shape=(m,),
                                            replace=False))


# -- the local-rows product -----------------------------------------------------


def _local_problem(n=64, k=4, d=3, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    idx[:, 1] = np.arange(n)                     # a padding slot a row
    w[:, 1] = 0.0
    return X, idx, w


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("row0,nb", [(0, 16), (32, 16), (48, 16), (39, 13)])
def test_local_rows_match_jax_kernel(row0, nb, storage):
    """The plain version and `ops.ell_lap_matvec_local(impl="torch")`
    against JAX's local-rows kernel in interpret mode on a row slice of an
    n = 64 graph (rows stay global ids); nb = 13 is not a multiple of 8."""
    X, idx, w = _local_problem()
    sl = slice(row0, row0 + nb)
    want = np.asarray(jops.ell_lap_matvec_local(
        jnp.asarray(X), jnp.asarray(idx[sl]), jnp.asarray(w[sl]), row0,
        block_rows=nb, interpret=True, storage=storage, lane=8))
    got = ops.ell_lap_matvec_local(torch.tensor(X), torch.tensor(idx[sl]),
                                   torch.tensor(w[sl]), row0, impl="torch",
                                   storage=storage)
    assert ops.last_dispatch("ell_lap_matvec_local") == {
        "path": "torch", "reason": "forced-off", "storage": storage}
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)
    if storage == "float32":
        plain = ell_lap_matvec_local_ref(torch.tensor(X),
                                         torch.tensor(idx[sl]),
                                         torch.tensor(w[sl]), row0)
        np.testing.assert_allclose(plain.numpy(), want, rtol=5e-5,
                                   atol=5e-5)
        full = np.asarray(jell_ref(jnp.asarray(X), jnp.asarray(idx),
                                   jnp.asarray(w)))[sl]
        np.testing.assert_allclose(plain.numpy(), full, rtol=5e-5,
                                   atol=5e-5)


def test_local_rows_dispatch_and_row_ranges():
    X, idx, w = (torch.tensor(a) for a in _local_problem())
    ops.ell_lap_matvec_local(X, idx[:16], w[:16], 0)
    assert ops.last_dispatch("ell_lap_matvec_local") == {
        "path": "torch", "reason": "cpu-tensor", "storage": "float32"}
    with pytest.raises(ValueError, match="CUDA"):
        ops.ell_lap_matvec_local(X, idx[:16], w[:16], 0, impl="kernel")
    with pytest.raises(ValueError, match=r"row0 = 49 must lie in .* = \[0, 48\]"):
        ops.ell_lap_matvec_local(X, idx[:16], w[:16], 49)
    with pytest.raises(ValueError, match="row0 = -1"):
        ops.ell_lap_matvec_local(X, idx[:16], w[:16], -1)
    with pytest.raises(ValueError, match="1 to n_x = 8"):
        ops.ell_lap_matvec_local(X[:8], idx[:16], w[:16], 0)
    assert ops.resolve_local_ell(24, 4, 0, storage_dtype="bfloat16") == {
        "impl": "auto", "storage": "bfloat16"}
    with pytest.raises(ValueError, match="impl"):
        ops.resolve_local_ell(24, 4, 2, impl="pallas")
    with pytest.raises(ValueError, match="nb, k >= 1"):
        ops.resolve_local_ell(0, 4, 2)


# -- the problems, computed once with JAX ---------------------------------------


@pytest.fixture(scope="module")
def problem():
    """JAX's side of every sharded check: inputs and single-device results.

    n = 50 for E/G and the operator (rows padded: 2 ranks hold 32 + 32 rows,
    4 ranks 16 each); the fits' n = 72 (4 ranks hold 24 rows each, so rank 3
    holds padding only)."""
    rng = np.random.default_rng(0)
    n = 50
    Y = rng.normal(size=(n, 6)).astype(np.float32)
    X = (0.5 * rng.normal(size=(n, 2))).astype(np.float32)
    key, key2 = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    eg = {}
    for kind, lam in EG_CASES:
        js = jsparse_affinities(jnp.asarray(Y), k=10, perplexity=3.0,
                                model=kind)
        for m in (N_NEG, None):
            shifts = (np.asarray(1 + jax.random.choice(
                key, n - 1, shape=(m,), replace=False)) if m else None)
            shifts2 = (np.asarray(1 + jax.random.choice(
                key2, n - 1, shape=(m,), replace=False)) if m else None)
            kw = dict(n_negatives=m, key=key if m else None)
            if kind == "tsne":
                E, G, z = jeg_sparse(jnp.asarray(X), js, kind, lam,
                                     return_state=True, **kw)
                _, G2, z2 = jeg_sparse(
                    jnp.asarray(X), js, kind, lam, n_negatives=m,
                    key=key2 if m else None, z_prev=z, return_state=True)
                want = {"z": float(z), "G2": np.asarray(G2),
                        "z2": float(z2)}
            else:
                E, G = jeg_sparse(jnp.asarray(X), js, kind, lam, **kw)
                want = {}
            want.update(E=float(E), G=np.asarray(G))
            eg[kind, m] = {"job": {"kind": kind, "lam": lam, "m": m,
                                   "arrays": _arrays(js), "X": X,
                                   "shifts": shifts, "shifts2": shifts2},
                           "want": want}
    js = jsparse_affinities(jnp.asarray(Y), k=10, perplexity=3.0, model="ee")
    V = rng.normal(size=(n, 2)).astype(np.float32)
    mv, inv_diag, mu = jsd_operator(js.graph, js.rev, 1e-5)
    op = {"job": {"arrays": _arrays(js), "V": V, "mu_scale": 1e-5},
          "want": {"mv": np.asarray(mv(jnp.asarray(V))),
                   "inv_diag": np.asarray(inv_diag), "mu": float(mu)}}
    return {"eg": eg, "op": op, "fits": {}}


def _fit_problem(problem, kind, lam, mu_scale):
    """The reference's single-device sparse fit (the problem of
    tests/test_torch_sparse.py::_fit_pair) and the inputs that carry it to
    the port: graph, start and per-iteration draws."""
    key = (kind, mu_scale)
    if key in problem["fits"]:
        return problem["fits"][key]
    Y = np.array(three_loops(n_per=24, loops=3, dim=8), dtype=np.float32)
    jspec = JEmbedSpec(kind=kind, lam=lam, strategy="sd", backend="sparse",
                       perplexity=8.0, max_iters=FIT_ITERS, tol=0.0,
                       n_neighbors=20, n_negatives=8, mu_scale=mu_scale,
                       kernel_impl="jnp")
    js = jsparse_affinities(jnp.asarray(Y), k=20, perplexity=8.0, model=kind)
    X0 = jspectral_init(jspec, js, Y.shape[0])
    jd = []
    jres = JEmbedding(jspec).fit(None, X0=X0, saff=js,
                                 callback=lambda it, X, e, d: jd.append(d)
                                 ).result_
    fields = dataclasses.asdict(jspec)
    n = Y.shape[0]
    table = [_jax_shifts(jspec.seed + 1, it, n, jspec.n_negatives)
             for it in range(FIT_ITERS + 1)]
    out = {"job": {"spec_fields": fields, "arrays": _arrays(js),
                   "X0": np.asarray(X0), "shift_table": table},
           "want": {"energies": np.asarray(jres.energies),
                    "pcg_iters": [d["pcg_iters"] for d in jd],
                    "z_ema": [d.get("z_ema") for d in jd]},
           "Y": Y}
    problem["fits"][key] = out
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(problem, tmp_path_factory):
    """`runs(world)`: every rank's results of the one spawn of that size."""
    def get(world):
        if world not in _RUNS:
            jobs = [(f"eg-{kind}-{m}", "energy_grad", case["job"])
                    for (kind, m), case in problem["eg"].items()]
            jobs.append(("op", "operator", problem["op"]["job"]))
            mus = (1e-3, 1e-5) if world == 4 else (1e-3,)
            for kind, lam in FITS:
                for mu in mus:
                    fp = _fit_problem(problem, kind, lam, mu)
                    jobs.append((f"fit-{kind}-{mu}", "fit", fp["job"]))
            if world == 2:
                fp = _fit_problem(problem, "tsne", 1.0, 1e-3)
                budget = dict(fp["job"]["spec_fields"], max_iters=50)
                jobs.append(("budget", "budget", {
                    "spec_fields": budget, "arrays": fp["job"]["arrays"],
                    "X0": fp["job"]["X0"], "max_seconds": 0.45,
                    "sleep_s": 0.3}))
                jobs.append(("api", "api", {"spec_fields": {
                    "kind": "ee", "lam": 20.0, "backend": "sparse-sharded",
                    "perplexity": 8.0, "n_neighbors": 20, "n_negatives": 8,
                    "max_iters": 4, "tol": 0.0, "mu_scale": 1e-3},
                    "Y": fp["Y"]}))
            _RUNS[world] = worker.spawn_ranks(
                world, jobs, tmp_path_factory.mktemp(f"ranks{world}"))
        return _RUNS[world]
    return get


# -- sharded energy / gradient and operator -------------------------------------


@pytest.mark.parametrize("mode", ["sampled", "exhaustive"])
@pytest.mark.parametrize("kind", [k for k, _ in EG_CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_energy_grad_matches_jax(runs, problem, world, kind, mode):
    """Every rank's sharded E, G (and z, and a second application from a
    warm z) within 1e-5 relative of JAX's single-device
    `energy_and_grad_sparse` with the same shifts; e_only equals eg's E."""
    m = N_NEG if mode == "sampled" else None
    want = problem["eg"][kind, m]["want"]
    nb = {1: 56, 2: 32, 4: 16}[world]
    for rank, res in enumerate(runs(world)):
        got = res[f"eg-{kind}-{m}"]
        assert (got["nb"], got["row0"], got["n_pad"]) == (nb, rank * nb,
                                                          nb * world)
        assert abs(got["E"] - want["E"]) <= 1e-5 * abs(want["E"])
        assert _rel(got["G"], want["G"]) <= 1e-5
        assert got["E_only"] == got["E"]
        if kind == "tsne":
            assert abs(got["z"] - want["z"]) <= 1e-5 * abs(want["z"])
            assert _rel(got["G2"], want["G2"]) <= 1e-5
            assert abs(got["z2"] - want["z2"]) <= 1e-5 * abs(want["z2"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sd_operator_matches_jax(runs, problem, world):
    """The matvec against JAX's single-device operator at rtol 1e-5 /
    atol 1e-6.  inv_diag and mu are the single-device operator's, bit for
    bit, as the reference asserts of its own two; against JAX's they agree
    at rtol 1e-5, the single-device bound (tests/test_torch_sparse.py),
    since the in-degree's float32 sum runs in another order."""
    want = problem["op"]["want"]
    for res in runs(world):
        got = res["op"]
        np.testing.assert_allclose(got["mv"], want["mv"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["inv_diag"],
                                      got["single_inv_diag"])
        assert got["mu"] == got["single_mu"]
        np.testing.assert_allclose(got["inv_diag"], want["inv_diag"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-5)


# -- whole fits -----------------------------------------------------------------


@pytest.mark.parametrize("kind,lam", FITS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_fit_matches_jax(runs, problem, world, kind, lam):
    """Five SD iterations at mu_scale = 1e-3 through
    build_sparse_objective(sharded=True) and fit_loop: the reference's
    single-device trace at rtol 1e-4 with the same PCG counts."""
    want = _fit_problem(problem, kind, lam, 1e-3)["want"]
    for res in runs(world):
        got = res[f"fit-{kind}-0.001"]
        assert got["n_iters"] == FIT_ITERS
        np.testing.assert_allclose(got["energies"], want["energies"],
                                   rtol=1e-4)
        assert got["pcg_iters"] == want["pcg_iters"]
        assert got["energies"][-1] < got["energies"][0]
        if kind == "tsne":
            np.testing.assert_allclose(got["z_ema"], want["z_ema"],
                                       rtol=1e-4)


@pytest.mark.parametrize("kind,lam", FITS)
def test_sharded_fit_at_default_mu_scale(runs, problem, kind, lam):
    """At the default mu_scale = 1e-5, four ranks: the reference's own
    sharded-vs-single-device bound, rtol 5e-3."""
    want = _fit_problem(problem, kind, lam, 1e-5)["want"]
    for res in runs(4):
        got = res[f"fit-{kind}-1e-05"]
        np.testing.assert_allclose(got["energies"], want["energies"],
                                   rtol=5e-3)
        assert got["energies"][-1] < got["energies"][0]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_return_bit_identical_results(runs, world):
    """Energies, step sizes, gradient norms, evaluations and X of every
    fit are the same bits on every rank."""
    ranks = runs(world)
    for name, got in ranks[0].items():
        if not name.startswith("fit-"):
            continue
        for other in ranks[1:]:
            for field in ("energies", "step_sizes", "grad_norms",
                          "n_fevals", "X"):
                np.testing.assert_array_equal(other[name][field],
                                              got[field], err_msg=name)


def test_time_budget_ends_every_rank_on_the_same_iteration(runs):
    """max_seconds under ranks whose clocks differ (rank 1 sleeps 0.3 s in
    every callback): the ranks agree on the slowest clock and stop
    together, short of max_iters, with the same results."""
    r0, r1 = (res["budget"] for res in runs(2))
    assert r0["n_iters"] == r1["n_iters"] < 50
    np.testing.assert_array_equal(r0["energies"], r1["energies"])
    np.testing.assert_array_equal(r0["X"], r1["X"])


# -- the API --------------------------------------------------------------------


def test_api_sharded_fit_equals_trainer_level_run(runs):
    """`Embedding(EmbedSpec(backend="sparse-sharded"), mesh=...)` in a
    2-rank group from Y (graph built on every rank) is the trainer-level
    run of the same spec, bit for bit, on every rank."""
    for res in runs(2):
        api, trainer = res["api"]["api"], res["api"]["trainer"]
        assert api["backend"] == "sparse-sharded"
        np.testing.assert_array_equal(api["X0"], trainer["X0"])
        np.testing.assert_array_equal(api["energies"], trainer["energies"])
        np.testing.assert_array_equal(api["X"], trainer["X"])
        assert api["energies"][-1] < api["energies"][0]
    a, b = (res["api"]["api"] for res in runs(2))
    np.testing.assert_array_equal(a["X"], b["X"])


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_resolve_backend_follows_the_reference(n_devices):
    """The reference's `auto` table, its dense-mesh pick included.  Inside a
    2-rank group the estimator resolves with the group's size."""
    for n in (100, 2048, 2049, 10 ** 5):
        for strategy in ("sd", "fp", "gd"):
            want = jresolve_backend("auto", n=n, n_devices=n_devices,
                                    strategy=strategy)
            got = resolve_backend("auto", n=n, n_devices=n_devices,
                                  strategy=strategy)
            assert got == want
    assert resolve_backend("sparse-sharded", n=10, strategy="sd") == \
        "sparse-sharded"


def test_estimator_auto_picks_sharded_in_a_group(runs):
    for res in runs(2):
        assert res["api"]["auto"] == {2048: "dense-mesh",
                                      2049: "sparse-sharded"}


def _jax_message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


class _Shape:
    """A mesh as JAX's validate_sparse_mesh reads it: its shape alone."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("case", ["non_row_axis", "row_axis_missing", "aff",
                                  "saff"])
def test_api_refusals_match_the_reference(runs, case):
    """In a 2-rank group: a mesh with a non-row axis of size 2, a row axis
    the mesh lacks, aff= and saff= raise the reference's messages."""
    want = {
        "non_row_axis": lambda: jvalidate_sparse_mesh(
            _Shape({"data": 1, "model": 2}), ("data",)),
        "row_axis_missing": lambda: jvalidate_sparse_mesh(
            _Shape({"data": 2, "model": 1}), ("rows",)),
        "aff": lambda: jfit_sparse_sharded(None, None, aff=object()),
        "saff": lambda: jfit_sparse_sharded(None, None, saff=object()),
    }[case]
    for res in runs(2):
        assert res["api"]["errors"][case] == _jax_message(want)


@pytest.mark.parametrize("shape,row_axes,ok", [
    ({"a": 2, "b": 2}, ("a", "b"), True),
    ({"a": 1, "b": 4}, ("b", "a"), True),
    ({"a": 2, "b": 2}, ("b", "a"), False),
])
def test_row_axes_must_follow_the_mesh_order(shape, row_axes, ok):
    """The slab is gathered in rank order, so the row axes of size > 1 must
    come in the mesh's order (shard i is rank i's); axes of size 1 may
    stand anywhere."""
    if ok:
        validate_sparse_mesh(_Shape(shape), row_axes)
    else:
        with pytest.raises(ValueError, match="in the mesh's order"):
            validate_sparse_mesh(_Shape(shape), row_axes)


def test_sharded_backend_needs_a_process_group():
    """Without a process group the estimator refuses, saying how to start
    one; the trainer refuses without a mesh (the reference's message); the
    backend refuses aff=/saff= before it reads the mesh."""
    Y = np.random.default_rng(0).normal(size=(40, 5)).astype(np.float32)
    spec = EmbedSpec(backend="sparse-sharded", perplexity=5.0, max_iters=2)
    with pytest.raises(ValueError, match="init_process_group"):
        Embedding(spec, device="cpu").fit(Y)
    with pytest.raises(ValueError, match="needs a mesh"):
        build_sparse_objective(spec, Y, sharded=True, device="cpu")
    with pytest.raises(ValueError, match="saff="):
        fit_sparse_sharded(spec, Y, saff=object(), device="cpu")
    with pytest.raises(ValueError, match="rows only"):
        validate_sparse_mesh(_Shape({"data": 1, "model": 2}), ("data",))


def test_mesh_errors_and_row_index(runs):
    for rank, res in enumerate(runs(2)):
        assert "has 3 ranks; the process group has 2" in \
            res["api"]["errors"]["mesh_size"]
        assert res["api"]["linear_row_index"] == [rank, rank]


def test_shards_refuse_a_graph_index_out_of_range(runs):
    """The local-rows kernel gathers its indices unchecked, so the shards
    are built only from a graph whose indices lie in [0, n)."""
    for res in runs(2):
        assert "the graph's indices must lie in [0, " in \
            res["api"]["errors"]["index_range"]


def test_ranks_that_disagree_on_the_set_up_all_raise(runs):
    """assert_replicated passes tensors every rank holds alike and raises
    on every rank (no rank left waiting) when one rank's differ."""
    for res in runs(2):
        errors = res["api"]["errors"]
        assert errors["replicated_same"] is None
        assert "different graphs or starting points" in \
            errors["replicated_differ"]


def test_spec_and_convert_take_sparse_sharded():
    spec = convert.spec_from_jax_fields(dataclasses.asdict(
        JEmbedSpec(backend="sparse-sharded", kernel_impl="pallas")))
    assert spec.backend == "sparse-sharded" and spec.kernel_impl == "kernel"
    assert EmbedSpec(backend="sparse-sharded", strategy="fp").backend == \
        "sparse-sharded"
