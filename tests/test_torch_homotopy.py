"""The port's dense minimizer (`core.minimize._minimize`) and homotopy path
(`core.homotopy.homotopy_path`) against the JAX reference.

Both packages start from the same affinities and start (JAX's, carried
across by convert.py), so the traces differ only by the rounding of each
step.  Energies at rtol 1e-4 (the reference's trace tolerance,
tests/test_api.py:92), iteration and evaluation counts exactly.  The
convergence test (relative decrease < tol) reads float64 copies of float32
energies in both packages, so the stage at which it fires is compared
exactly too.
"""
import numpy as np
import pytest
import torch

from repro.core import FP as JFP
from repro.core import SD as JSD
from repro.core import homotopy_path as jhomotopy
from repro.core import laplacian_eigenmaps as jeig
from repro.core import make_affinities as jmake
from repro.core import make_strategy as jmake_strategy
from repro.core.linesearch import LSConfig as JLSConfig
from repro.core.minimize import _minimize as jminimize
from repro_torch import convert
from repro_torch.core import (FP, SD, HomotopyResult, LSConfig,
                              MinimizeResult, homotopy_path, make_strategy)
from repro_torch.core.minimize import _minimize
from tests.conftest import three_loops


@pytest.fixture(scope="module")
def problem():
    Y = three_loops(n_per=16, loops=2, dim=8)
    aff = jmake(Y, 8.0, model="ee")
    X0 = jeig(aff.Wp, 2) * 0.1
    return aff, X0


def _port(problem):
    aff, X0 = problem
    return (convert.affinities_from_numpy(aff.Wp, aff.Wm, "cpu"),
            convert.embedding_from_numpy(X0, "cpu"))


def _jax_and_port_paths(problem, name, lam, **kw):
    aff, X0 = problem
    jstrat = {"SD": JSD, "FP": JFP}[name]()
    pstrat = {"SD": SD, "FP": FP}[name]()
    want = jhomotopy(X0, aff, "ee", jstrat, lam_final=lam, **kw)
    paff, pX0 = _port(problem)
    return want, homotopy_path(pX0, paff, "ee", pstrat, lam_final=lam, **kw)


def _hold_stage(got, want):
    """One stage: the same iterations and evaluations, energies at rtol
    1e-4."""
    assert got.n_iters == want.n_iters
    np.testing.assert_array_equal(got.n_fevals, want.n_fevals)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-4)


@pytest.mark.parametrize("name,lam", [("SD", 5.0), ("SD", 1.0), ("FP", 1.0)])
def test_homotopy_path_matches_jax(problem, name, lam):
    """Four log-spaced stages from lambda = 1e-4, five iterations each, with
    fig3's SD and FP: every stage's trace, iterations and evaluations.
    (To lambda = 50 the last stage parts as the reference parts from
    itself: test_homotopy_to_lambda_50.)"""
    kw = dict(n_stages=4, tol=0.0, max_iters=5)
    want, got = _jax_and_port_paths(problem, name, lam, **kw)
    assert isinstance(got, HomotopyResult)
    np.testing.assert_allclose(got.lambdas, want.lambdas, rtol=1e-12)
    np.testing.assert_array_equal(got.iters_per_lambda, want.iters_per_lambda)
    np.testing.assert_array_equal(got.fevals_per_lambda,
                                  want.fevals_per_lambda)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-4)
    for r, rj in zip(got.results, want.results):
        _hold_stage(r, rj)
    assert len(got.results) == 4 and got.time_per_lambda.shape == (4,)
    assert got.X.shape == want.X.shape and bool(torch.isfinite(got.X).all())


def test_homotopy_to_lambda_50(problem):
    """SD to lambda = 50 over 4 stages.  Stages 1-3 (lambda up to 13.6) are
    held as above.  Stage 4 starts at lambda = 50 from stage 3's minimizer,
    where the first step already amplifies a last-bit difference: from
    JAX's own stage-3 embedding, the reference's jnp and Pallas-interpret
    kernel paths part by ~5e-4 after one iteration (ROADMAP.md, Queue 3).
    So stage 4 is held at its start (rtol 1e-4) and its first iteration
    within the reference's own gap there.  Its iterations and evaluations
    are held exactly, as every other stage's are, on a rerun of the stage
    from JAX's stage-3 embedding: the port's own stage-3 embedding matches
    JAX's energies at rtol 1e-4 but not its coordinates, and from it the
    port backtracks once more at the third iteration, in float64 as in
    float32, so the count there follows the start."""
    from repro.api import Embedding as JEmbedding
    from repro.api import EmbedSpec as JEmbedSpec
    kw = dict(n_stages=4, tol=0.0, max_iters=5)
    want, got = _jax_and_port_paths(problem, "SD", 50.0, **kw)
    for r, rj in zip(got.results[:3], want.results[:3]):
        _hold_stage(r, rj)
    last, last_j = got.results[3], want.results[3]
    np.testing.assert_array_equal(got.iters_per_lambda, want.iters_per_lambda)
    paff, _ = _port(problem)
    rerun = _minimize(convert.embedding_from_numpy(want.results[2].X, "cpu"),
                      paff, "ee", float(want.lambdas[3]), SD(), tol=0.0,
                      max_iters=5)
    assert rerun.n_iters == last_j.n_iters == last.n_iters
    np.testing.assert_array_equal(rerun.n_fevals, last_j.n_fevals)
    np.testing.assert_allclose(last.energies[0], last_j.energies[0],
                               rtol=1e-4)
    aff, _ = problem
    spec = dict(kind="ee", strategy="sd", backend="dense", lam=50.0,
                max_iters=1, tol=0.0, ls=JLSConfig())
    own = [JEmbedding(JEmbedSpec(**spec, kernel_impl=impl)).fit(
        None, X0=want.results[2].X, aff=aff).result_.energies[1]
        for impl in ("jnp", "pallas-interpret")]
    own_gap = abs(own[0] - own[1]) / abs(own[0])
    assert own_gap > 1e-4            # the reference parts from itself
    assert abs(last.energies[1] - own[0]) / abs(own[0]) <= own_gap
    assert last.energies[-1] < last.energies[0]


def test_homotopy_descends_every_stage(problem):
    """Each stage's minimization never raises its energy, and the path ends
    below the start's energy at the target lambda."""
    from repro_torch.core import energy
    paff, pX0 = _port(problem)
    res = homotopy_path(pX0, paff, "ee", SD(), lam_final=50.0, n_stages=4,
                        tol=1e-4, max_iters=60)
    for r in res.results:
        assert np.all(np.diff(r.energies) <= 0)
    assert res.energies[-1] < float(energy(pX0, paff, "ee", 50.0))


@pytest.mark.parametrize("k,mu_scale", [(7, 1e-5), (-1, 1e-3)])
def test_minimize_sparsesd_matches_jax(problem, k, mu_scale):
    """`make_strategy("sparsesd")` through the dense minimizer on dense
    affinities (the full graph at mu_scale = 1e-3: see
    test_torch_strategies.py)."""
    aff, X0 = problem
    ls = dict(init_step="adaptive_grow")
    want = jminimize(X0, aff, "ee", 50.0,
                     jmake_strategy("sparsesd", k=k, mu_scale=mu_scale),
                     max_iters=5, tol=0.0, ls_cfg=JLSConfig(**ls))
    paff, pX0 = _port(problem)
    got = _minimize(pX0, paff, "ee", 50.0,
                    make_strategy("sparsesd", k=k, mu_scale=mu_scale),
                    max_iters=5, tol=0.0, ls_cfg=LSConfig(**ls))
    assert isinstance(got, MinimizeResult)
    assert got.n_iters == want.n_iters == 5
    np.testing.assert_array_equal(got.n_fevals, want.n_fevals)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-4)
    assert got.energies[-1] < got.energies[0]
    assert got.strategy_state["prev_P"].shape == X0.shape


def test_minimize_callback_tol_and_budget(problem):
    """The minimizer's glue: raw convergence stops early as the reference's
    does, the callback sees each iteration, and max_seconds stops the loop
    (the reference's test_max_seconds_budget)."""
    aff, X0 = problem
    paff, pX0 = _port(problem)
    ls = dict(init_step="adaptive_grow")
    want = jminimize(X0, aff, "ee", 50.0, JSD(), max_iters=500, tol=1e-3,
                     ls_cfg=JLSConfig(**ls))
    seen = []
    got = _minimize(pX0, paff, "ee", 50.0, SD(), max_iters=500, tol=1e-3,
                    ls_cfg=LSConfig(**ls),
                    callback=lambda it, X, e, d: seen.append(it))
    assert got.converged and want.converged
    assert got.n_iters == want.n_iters < 500
    np.testing.assert_array_equal(got.n_fevals, want.n_fevals)
    np.testing.assert_allclose(got.energies, want.energies, rtol=1e-4)
    assert seen == list(range(1, got.n_iters + 1))
    assert len(got.times) == len(got.energies) == got.n_iters + 1
    budget = _minimize(pX0, paff, "ee", 50.0, make_strategy("gd"),
                       max_iters=100_000, tol=0.0, max_seconds=0.2)
    assert budget.n_iters < 100_000 and budget.times[-1] < 20.0
