"""The port's dense-mesh backend against the JAX reference.

`repro_torch.embed.distributed` (the 2-D-sharded tile, its energy and
gradient, the block-Jacobi factors and solve), `launch.mesh.Mesh`'s axis
groups, `build_dense_mesh_objective` and `Embedding(backend="dense-mesh")`.
The port runs in 1, 2, 4 and 8 gloo ranks on the CPU, spawned by
tests/test_torch_sharding_ranks.py (which imports no JAX); the reference's
mesh functions run in one subprocess with 8 forced host devices (the
pattern of tests/test_distributed_embed.py), since this process must keep
seeing one device.  Inputs are made here with numpy and handed to both.

Tolerances: the tile and the mesh E and G against JAX's mesh functions at
rtol 1e-5 (G relative in norm); the mesh E and G against the dense
`core.energy_and_grad` at the reference's 1e-4 (tests/test_distributed_embed
.py:41-43); the block-Jacobi factors at the reference's rtol 1e-3 / atol
1e-5 (tests/test_distributed_embed.py:62) and, tighter, 1e-5; fits' energy
traces at rtol 1e-4 (tests/test_api.py:92).

JAX's dense-mesh fit (`tests/test_api.py::test_dense_mesh_backend_
strategies`) fails on jax 0.9 (ROADMAP, "Reference caveats"): the engine's
`vdot(G, P)` cannot contract a row-sharded G with a row-sharded P.  The
reference trace here comes from `build_dense_mesh_objective` and
`fit_loop` with one test-side adapter, `_replicated_g`, which replicates G
after each evaluation (what the reference's global arrays mean, and what
the port's objective hands its engine); no JAX file changes.

FP and GD on EE at lambda = 50 amplify a last-bit difference (ROADMAP,
"Properties to know"): from JAX's start, FP parts from JAX by 1.1e-4 after
six iterations, as the reference's own paths part from one another.  So
FP's trace is held at lambda = 1, as tests/test_torch_api.py holds the dense
one; at lambda = 50 SD, FP and GD are held to the reference's own checks
(descent, three distinct results) and SD and GD to JAX's traces.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sharding_ranks as worker
from repro.api import EmbedSpec as JEmbedSpec
from repro.api.backends import fit_dense_mesh as jfit_dense_mesh
from repro.api.registries import resolve_backend as jresolve_backend
from repro.core import energy_and_grad as jenergy_and_grad
from repro.core import make_affinities as jmake_affinities
from repro.embed import distributed as jdist
from repro.embed import replicate as jreplicate
from repro.embed.engine import fit_loop as jfit_loop
from repro.embed.trainer import build_dense_mesh_objective as jbuild
from repro.embed.trainer import make_loop_config as jloop_config
from repro_torch.api import EmbedSpec, resolve_backend
from repro_torch.embed import distributed
from tests.conftest import three_loops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 64
KINDS = ("ee", "ssne", "tsne", "tee", "epan")
EG_CASES = (("ee", 50.0), ("tsne", 1.0))
#: (shape, row axes, column axis) of the 8-rank meshes; the third names
#: its row axes out of the mesh's order, so its row blocks are not in rank
#: order
MESHES_8 = {
    "2x4": ({"data": 2, "model": 4}, ("data",), "model"),
    "4x2": ({"data": 4, "model": 2}, ("data",), "model"),
    "2x2x2": ({"a": 2, "b": 2, "m": 2}, ("b", "a"), "m"),
}
FIT_ITERS = 6
FITS_1 = {                      # (1, 1): name -> (kind, lam, strategy)
    "sd-ee-50": ("ee", 50.0, "sd"),
    "gd-ee-50": ("ee", 50.0, "gd"),
    "fp-ee-50": ("ee", 50.0, "fp"),
    "sd-tsne-1": ("tsne", 1.0, "sd"),
    "fp-ee-1": ("ee", 1.0, "fp"),
    "gd-ee-1": ("ee", 1.0, "gd"),
}
HELD_1 = ("sd-ee-50", "gd-ee-50", "sd-tsne-1", "fp-ee-1", "gd-ee-1")
FITS_MULTI = {"sd-ee-50": ("ee", 50.0, "sd"), "sd-tsne-1": ("tsne", 1.0,
                                                             "sd")}


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _fields(kind, lam, strategy, **kw):
    return {"kind": kind, "lam": lam, "strategy": strategy,
            "backend": "dense-mesh", "perplexity": 8.0,
            "max_iters": FIT_ITERS, "tol": 0.0, **kw}


def _replicated_g(obj, mesh):
    """The test-side adapter: the objective's G replicated after each
    evaluation, so that jax 0.9's engine can contract it with P."""
    eg = obj._eg

    def eg_replicated(X):
        E, G = eg(X)
        return E, jreplicate(mesh, G)

    obj._eg = eg_replicated
    return obj


def _jax_fit(fields, Y, mesh):
    spec = JEmbedSpec(**fields)
    obj, X = jbuild(spec, mesh, None, jnp.asarray(Y), None,
                    strategy=spec.strategy)
    res = jfit_loop(_replicated_g(obj, mesh), X,
                    jloop_config(spec, spec.resolved_ls()))
    return np.asarray(res.energies), np.asarray(X)


# -- the reference on 8 forced host devices ------------------------------------

_JAX_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.api import EmbedSpec
    from repro.embed import (EmbedMeshSpec, make_block_jacobi_setup,
                             make_block_jacobi_solve,
                             make_distributed_energy_grad, replicate,
                             shard_pairwise, shard_rows)
    from repro.embed.engine import fit_loop
    from repro.embed.trainer import (build_dense_mesh_objective,
                                     make_loop_config)
    assert len(jax.devices()) == 8
    inp = np.load(sys.argv[1], allow_pickle=True)
    meshes = inp["meshes"].item()
    out = {}

    def mesh_of(shape):
        n = int(np.prod(list(shape.values())))
        devs = np.array(jax.devices()[:n]).reshape(tuple(shape.values()))
        return Mesh(devs, tuple(shape))

    X = jnp.asarray(inp["X"])
    for name, (shape, row_axes, col_axis) in meshes.items():
        mesh = mesh_of(shape)
        spec = EmbedMeshSpec(row_axes=row_axes, col_axis=col_axis)
        for kind, lam in inp["eg_cases"]:
            lam = float(lam)
            Wp = shard_pairwise(mesh, spec, jnp.asarray(inp["Wp_" + kind]))
            Wm = shard_pairwise(mesh, spec, jnp.asarray(inp["Wm_" + kind]))
            E, G = make_distributed_energy_grad(mesh, spec, kind)(
                X, Wp, Wm, lam)
            Eu, Gu = make_distributed_energy_grad(mesh, spec, kind,
                                                  unit_wm=True)(X, Wp, lam)
            out[f"{name}/{kind}/two"] = (float(E), np.asarray(G))
            out[f"{name}/{kind}/unit"] = (float(Eu), np.asarray(Gu))
    mesh = mesh_of({"data": 2, "model": 4})
    spec = EmbedMeshSpec()
    Wp = shard_pairwise(mesh, spec, jnp.asarray(inp["Wp_ee"]))
    R = make_block_jacobi_setup(mesh, spec, 1e-5)(Wp)
    P = make_block_jacobi_solve(mesh, spec)(
        R, shard_rows(mesh, spec, jnp.asarray(inp["G"])))
    out["bj"] = (np.asarray(R), np.asarray(P))
    Y = jnp.asarray(inp["Y_fit"])
    for shape in [(2, 1), (2, 2)]:
        mesh = mesh_of({"data": shape[0], "model": shape[1]})
        for name, fields in inp["fits"].item().items():
            cfg = EmbedSpec(**fields)
            obj, X0 = build_dense_mesh_objective(cfg, mesh, None, Y, None,
                                                 strategy=cfg.strategy)
            eg = obj._eg
            obj._eg = (lambda X, eg=eg, mesh=mesh:
                       (lambda e, g: (e, replicate(mesh, g)))(*eg(X)))
            res = fit_loop(obj, X0, make_loop_config(cfg,
                                                     cfg.resolved_ls()))
            out[f"fit/{shape}/{name}"] = (np.asarray(res.energies),
                                          np.asarray(X0))
    np.save(sys.argv[2], out, allow_pickle=True)
    print("JAX_MESH_OK")
""")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(21)
    Y = rng.normal(size=(N, 8)).astype(np.float32)
    X = (0.5 * rng.normal(size=(N, 2))).astype(np.float32)
    aff = {kind: jmake_affinities(jnp.asarray(Y), 10.0, model=kind)
           for kind, _ in EG_CASES}
    dense = {kind: tuple(np.asarray(v) for v in jenergy_and_grad(
        jnp.asarray(X), aff[kind], kind, lam)) for kind, lam in EG_CASES}
    return {"X": X, "G": rng.normal(size=(N, 2)).astype(np.float32),
            "Wp": {k: np.asarray(a.Wp) for k, a in aff.items()},
            "Wm": {k: np.asarray(a.Wm) for k, a in aff.items()},
            "dense": dense,
            "Y_fit": np.asarray(three_loops(n_per=16, loops=2, dim=8),
                                np.float32)}


@pytest.fixture(scope="module")
def jax_mesh(problem, tmp_path_factory):
    """Every reference result of the forced 8-device subprocess."""
    tmp = tmp_path_factory.mktemp("jax_mesh")
    inputs, out = tmp / "inputs.npz", tmp / "out.npy"
    np.savez(inputs, X=problem["X"], G=problem["G"],
             Y_fit=problem["Y_fit"], meshes=np.array(MESHES_8, dtype=object),
             eg_cases=np.array(EG_CASES, dtype=object),
             fits=np.array({name: _fields(*case)
                            for name, case in FITS_MULTI.items()},
                           dtype=object),
             **{f"Wp_{k}": v for k, v in problem["Wp"].items()},
             **{f"Wm_{k}": v for k, v in problem["Wm"].items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", _JAX_PROG, str(inputs),
                          str(out)], capture_output=True, text=True,
                         env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "JAX_MESH_OK" in run.stdout
    return np.load(out, allow_pickle=True).item()


_RUNS: dict = {}


@pytest.fixture(scope="module")
def ranks(problem, jax_mesh, tmp_path_factory):
    """`ranks(world)`: every rank's results of the one spawn of that size."""
    def jobs_of(world):
        if world == 8:
            cases = {}
            for kind, lam in EG_CASES:
                Wp, Wm = problem["Wp"][kind], problem["Wm"][kind]
                cases[f"{kind}/two"] = (kind, lam, Wp, Wm)
                cases[f"{kind}/unit"] = (kind, lam, Wp, None)
            jobs = [(f"eg/{name}", "dense_eg",
                     {"shape": shape, "row_axes": rows, "col_axis": col,
                      "X": problem["X"], "cases": cases})
                    for name, (shape, rows, col) in MESHES_8.items()]
            jobs.append(("bj", "block_jacobi", {
                "shape": {"data": 2, "model": 4}, "Wp": problem["Wp"]["ee"],
                "G": problem["G"], "mu_scale": 1e-5}))
            return jobs
        if world == 4:
            return [("groups", "mesh_groups", {"shapes": [
                        {"data": 2, "model": 2}, {"data": 1, "model": 4},
                        {"data": 4, "model": 1}]}),
                    ("fits", "dense_mesh_fits", _multi_fits(
                        jax_mesh, problem, (2, 2)))]
        resume = {"spec_fields": _fields("ee", 50.0, "sd",
                                         max_iters=2 * FIT_ITERS),
                  "Y": problem["Y_fit"],
                  "ckdir": str(tmp_path_factory.mktemp(f"ck{world}")),
                  "stop": FIT_ITERS}
        if world == 2:
            return [("fits", "dense_mesh_fits", _multi_fits(
                        jax_mesh, problem, (2, 1))),
                    ("resume", "resume", resume),
                    ("api", "dense_mesh_api", {"Y": problem["Y_fit"],
                                               "n_odd": 31})]
        fits = {name: (_fields(*case), _jax_single(problem)[name][1])
                for name, case in FITS_1.items()}
        return [("fits", "dense_mesh_fits", {
                    "shape": {"data": 1, "model": 1},
                    "Y": problem["Y_fit"], "runs": fits}),
                ("resume", "resume", resume)]

    def get(world):
        if world not in _RUNS:
            _RUNS[world] = worker.spawn_ranks(
                world, jobs_of(world),
                tmp_path_factory.mktemp(f"dense_ranks{world}"))
        return _RUNS[world]
    return get


def _multi_fits(jax_mesh, problem, shape):
    return {"shape": {"data": shape[0], "model": shape[1]},
            "Y": problem["Y_fit"],
            "runs": {name: (_fields(*case),
                            jax_mesh[f"fit/{shape}/{name}"][1])
                     for name, case in FITS_MULTI.items()}}


_SINGLE: dict = {}


def _jax_single(problem):
    """JAX's (1, 1) dense-mesh fits, through the adapter: {name:
    (energies, X0)}."""
    if not _SINGLE:
        mesh = jax.make_mesh((1, 1), ("data", "model"))
        for name, case in FITS_1.items():
            _SINGLE[name] = _jax_fit(_fields(*case), problem["Y_fit"], mesh)
    return _SINGLE


# -- the tile ------------------------------------------------------------------


@pytest.mark.parametrize("diag_tile", [True, False])
@pytest.mark.parametrize("two_matrices", [False, True])
@pytest.mark.parametrize("rows,cols", [(16, 32), (32, 16)])
@pytest.mark.parametrize("kind", KINDS)
def test_tile_matches_jax(kind, rows, cols, two_matrices, diag_tile):
    """`_tile_terms_local` on a rectangular tile, with W- given and with
    unit W-, on a diagonal tile and off it: the reference's at rtol 1e-5
    (L(a) X and L(b) X with an absolute part of 1e-5 max|.|)."""
    rng = np.random.default_rng(rows * 7 + cols + len(kind))
    xi = rng.normal(size=(rows, 2)).astype(np.float32)
    xj = rng.normal(size=(cols, 2)).astype(np.float32)
    wa = np.abs(rng.normal(size=(rows, cols))).astype(np.float32)
    wb = (np.abs(rng.normal(size=(rows, cols))).astype(np.float32)
          if two_matrices else None)
    want = jdist._tile_terms_local(
        kind, jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(wa),
        None if wb is None else jnp.asarray(wb), jnp.asarray(diag_tile))
    got = distributed._tile_terms_local(
        kind, torch.tensor(xi), torch.tensor(xj), torch.tensor(wa),
        None if wb is None else torch.tensor(wb), diag_tile)
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    E_only = distributed._tile_terms_local(
        kind, torch.tensor(xi), torch.tensor(xj), torch.tensor(wa),
        None if wb is None else torch.tensor(wb), diag_tile, with_grad=False)
    assert E_only[:2] == (None, None)
    assert all(torch.equal(a, b) for a, b in zip(E_only[2:], got[2:]))


# -- the mesh's E and G, factors and solve --------------------------------------


@pytest.mark.parametrize("wm", ["unit", "two"])
@pytest.mark.parametrize("kind,lam", EG_CASES)
@pytest.mark.parametrize("mesh", list(MESHES_8))
def test_energy_grad_matches_jax_mesh(ranks, jax_mesh, problem, mesh, kind,
                                      lam, wm):
    """Eight gloo ranks: every rank's E and G (its row block, and G
    replicated) against JAX's `make_distributed_energy_grad` on the same
    mesh at rtol 1e-5, and against the dense `core.energy_and_grad` at the
    reference's 1e-4; `with_grad=False` gives E's bits."""
    E_want, G_want = jax_mesh[f"{mesh}/{kind}/{wm}"]
    E_dense, G_dense = problem["dense"][kind]
    shape, row_axes, _ = MESHES_8[mesh]
    R = int(np.prod([shape[ax] for ax in row_axes]))
    nb = N // R
    seen = set()
    for res in ranks(8):
        got = res[f"eg/{mesh}"]
        r = got["row_block"]
        seen.add(r)
        case = got[f"{kind}/{wm}"]
        assert case["tile"] == (nb, N * R // 8)
        assert abs(case["E"] - E_want) <= 1e-5 * abs(E_want)
        assert abs(case["E"] - E_dense) <= 1e-4 * abs(E_dense)
        assert case["E_only"] == case["E"]
        rows = slice(r * nb, (r + 1) * nb)
        np.testing.assert_array_equal(got["rows"], problem["X"][rows])
        assert _rel(case["G_rows"], G_want[rows]) <= 1e-5
        assert _rel(case["G"], G_want) <= 1e-5
        assert _rel(case["G"], G_dense) <= 1e-4
        np.testing.assert_array_equal(case["G"][rows], case["G_rows"])
    assert seen == set(range(R))


def test_block_jacobi_matches_jax(ranks, jax_mesh, problem):
    """(2, 4): each rank's factor of its row block's diagonal block against
    JAX's at rtol 1e-5 (the reference's own bound is rtol 1e-3 / atol
    1e-5), and against numpy's Cholesky of the block the reference's test
    builds; the solve -B^-1 G against JAX's at rtol 1e-5, every rank with
    the same replicated P."""
    R_want, P_want = jax_mesh["bj"]
    Wp = problem["Wp"]["ee"].astype(np.float64)
    deg = Wp.sum(1)
    nb = N // 2
    Ps = []
    for res in ranks(8):
        got = res["bj"]
        sl = slice(got["row_block"] * nb, (got["row_block"] + 1) * nb)
        np.testing.assert_allclose(got["R"], R_want[sl], rtol=1e-5,
                                   atol=1e-6)
        B = 4.0 * (np.diag(deg[sl]) - Wp[sl, sl])
        B += max(1e-10 * np.diag(B).min(),
                 1e-5 * np.diag(B).mean()) * np.eye(nb)
        np.testing.assert_allclose(got["R"], np.linalg.cholesky(B),
                                   rtol=1e-3, atol=1e-5)
        assert _rel(got["P_rows"], P_want[sl]) <= 1e-5
        np.testing.assert_array_equal(got["P"][sl], got["P_rows"])
        Ps.append(got["P"])
    for P in Ps[1:]:
        np.testing.assert_array_equal(P, Ps[0])


def test_mesh_axis_groups(ranks):
    """Four ranks on (2, 2), (1, 4) and (4, 1) meshes: each rank's
    coordinates are row-major, `axis_group(axes)` holds the ranks that
    share its coordinates off `axes` (the same group on each of them), and
    a sum over its process group reaches exactly those ranks."""
    results = ranks(4)
    shapes = [(2, 2), (1, 4), (4, 1)]
    for i, (D, M) in enumerate(shapes):
        for rank, res in enumerate(results):
            mesh = res["groups"]["meshes"][i]
            d, m = divmod(rank, M)
            assert mesh["coords"] == {"data": d, "model": m}
            want = {(): (rank,),
                    ("data",): tuple(x * M + m for x in range(D)),
                    ("model",): tuple(d * M + y for y in range(M)),
                    ("data", "model"): tuple(range(4))}
            for axes, members in want.items():
                got, mask = mesh["groups"][axes]
                assert got == members, (shapes[i], rank, axes)
                assert mask == sum(2 ** x for x in members)


def test_make_host_mesh_model_axis(ranks):
    for res in ranks(4):
        assert res["groups"]["host2"] == {"data": 2, "model": 2}
        assert "model_axis=3 does not divide" in \
            res["groups"]["bad_model_axis"]


# -- fits ----------------------------------------------------------------------


@pytest.mark.parametrize("name", HELD_1)
def test_single_rank_fit_matches_jax(ranks, problem, name):
    """(1, 1), one gloo rank: `Embedding(backend="dense-mesh")` from JAX's
    start against JAX's `build_dense_mesh_objective` + `fit_loop` (G
    replicated by the adapter) at rtol 1e-4."""
    want = _jax_single(problem)[name][0]
    got = ranks(1)[0]["fits"][name]
    assert got["backend"] == "dense-mesh" and got["affinities"] is None
    assert len(got["energies"]) == FIT_ITERS + 1
    np.testing.assert_allclose(got["energies"], want, rtol=1e-4)


def test_single_rank_strategies_descend_and_differ(ranks):
    """The reference's own check of the backend (tests/test_api.py:
    test_dense_mesh_backend_strategies) at EE lambda = 50: sd, fp and gd
    each descend, and their results differ."""
    fits = ranks(1)[0]["fits"]
    last = []
    for s in ("sd", "fp", "gd"):
        e = fits[f"{s}-ee-50"]["energies"]
        assert e[-1] < e[0]
        last.append(round(float(e[-1]), 3))
    assert len(set(last)) == 3


@pytest.mark.parametrize("name", list(FITS_MULTI))
@pytest.mark.parametrize("world,shape", [(2, (2, 1)), (4, (2, 2))])
def test_multi_rank_fit_matches_jax(ranks, jax_mesh, world, shape, name):
    """SD on (2, 1) and (2, 2) meshes of gloo ranks: JAX's trace on the same
    forced-device mesh (through the adapter) at rtol 1e-4, and every rank's
    X, energies and steps the same bits."""
    want = jax_mesh[f"fit/{shape}/{name}"][0]
    results = [res["fits"][name] for res in ranks(world)]
    for got in results:
        assert got["backend"] == "dense-mesh"
        np.testing.assert_allclose(got["energies"], want, rtol=1e-4)
    for got in results[1:]:
        for field in ("energies", "step_sizes", "n_fevals", "X"):
            np.testing.assert_array_equal(got[field], results[0][field])


@pytest.mark.parametrize("world", [1, 2])
def test_resume_is_bit_equal(ranks, world):
    """SD stopped at 6 and resumed to 12 from the checkpoint (rank 0
    writes it; the block-Jacobi factors are built again) gives the
    uninterrupted run's energies and X, bit for bit, on every rank."""
    for res in ranks(world):
        full, resumed = res["resume"]["full"], res["resume"]["resumed"]
        assert resumed["resumed_from"] == FIT_ITERS
        assert resumed["n_iters"] == FIT_ITERS
        np.testing.assert_array_equal(resumed["energies"][1:],
                                      full["energies"][FIT_ITERS + 1:])
        np.testing.assert_array_equal(resumed["X"], full["X"])


# -- the API -------------------------------------------------------------------


def test_resolve_backend_matches_the_reference():
    for n in (64, 2046, 2048, 2049, 4096):
        for n_devices in (1, 2, 3, 4, 8):
            for strategy in ("sd", "fp", "gd", "diag", "lbfgs"):
                assert resolve_backend(
                    "auto", n=n, n_devices=n_devices, strategy=strategy) == \
                    jresolve_backend("auto", n=n, n_devices=n_devices,
                                     strategy=strategy), (n, n_devices,
                                                          strategy)


def test_estimator_auto_and_refusals_in_a_group(ranks):
    """In a 2-rank group `auto` picks dense-mesh for an even N up to 2048;
    aff= and saff= raise the reference's messages and an N that the mesh
    does not divide raises before any affinity is built."""
    def message(**kw):
        with pytest.raises(ValueError) as e:
            jfit_dense_mesh(None, None, **kw)
        return str(e.value)

    for res in ranks(2):
        api = res["api"]
        assert api["auto"] == {2046: "dense-mesh", 2047: "dense",
                               2048: "dense-mesh", 2049: "sparse-sharded"}
        assert api["errors"]["aff"] == message(aff=object())
        assert api["errors"]["saff"] == message(saff=object())
        assert "N = 31 must be divisible" in api["errors"]["indivisible"]


def test_dense_only_strategies_are_refused():
    for strategy in ("diag", "sd-", "lbfgs", "cg"):
        with pytest.raises(ValueError, match="not available on backend"):
            EmbedSpec(strategy=strategy, backend="dense-mesh")
    for strategy in ("sd", "fp", "gd"):
        assert EmbedSpec(strategy=strategy,
                         backend="dense-mesh").backend == "dense-mesh"
