"""The port's dense strategy lineup against the JAX reference: the kernel-
function algebra (core/kernels_fn.py), the Hessian terms (core/hessians.py),
batched CG (core/cg.py), and one direction each of DiagH, SD-, SparseSD,
L-BFGS and nonlinear CG.

Inputs are made with numpy from a seed and go through the JAX function and
its port.  Tolerances, with their reasons:

  * kernel functions: rtol 1e-6 — the same float32 formulas;
  * Hessian terms: relative Frobenius norm 1e-4, the reference's own
    tolerance against autodiff (tests/test_hessians.py:34,45);
  * batched CG: the iteration count exactly (the stopping test is the
    reference's, in float32), x at rtol 1e-4 with atol scaled by max|x|,
    the final relative residual at rtol 5e-2: it is the norm of the
    recursively updated residual, a small difference of float32 vectors
    that carries the rounding of every update (at tol 1e-3 the two packages
    part by ~1.4e-2 of it);
  * directions: those of tests/test_torch_core.py — rtol 1e-4 with atol
    scaled by max|P| for the solves (SD- and SparseSD, whose near-singular
    constant mode is compared without the column means, as SD's is), and
    for DiagH, whose diagonal carries rounding of its cancelling terms;
    rtol 1e-6 with atol 1e-7 max|P| for the updates without a solve
    (L-BFGS, nonlinear CG), which are GD-like.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import cg as jcg
from repro.core import hessians as jhess
from repro.core import kernels_fn as jkf
from repro.core import strategies as jstrat
from repro.core.affinities import make_affinities as jmake
from repro.core.objectives import energy_and_grad as jeg
from repro.sparse import sparse_affinities as jsparse_affinities
from repro_torch import convert
from repro_torch.core import (LBFGS, DiagH, NonlinearCG, SDMinus, SparseSD,
                              baselines, cg, hessians, kernels_fn,
                              make_strategy, strategies)
from repro_torch.core.affinities import Affinities
from repro_torch.core.objectives import direct_energy
from repro_torch.kernels.ref import KINDS
from tests.conftest import three_loops

LAMS = {"ee": 5.0, "ssne": 1.0, "tsne": 1.0, "tee": 5.0, "epan": 5.0}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, rtol=1e-4, rel_atol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel_atol * (np.abs(want).max() + 1e-30))


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _port_aff(jaff):
    return Affinities(_t(jaff.Wp), _t(jaff.Wm))


# -- kernel functions -----------------------------------------------------------


@pytest.mark.parametrize("fn", ["K", "K1", "K2", "K21"])
@pytest.mark.parametrize("name", sorted(jkf.KERNELS))
def test_kernel_functions_match_jax(name, fn):
    """On a grid through Epanechnikov's support edge (t = 1, both sides and
    within float32 rounding of it) and far beyond."""
    t = np.concatenate([np.linspace(0.0, 3.0, 301),
                        1.0 + np.array([-1e-3, -1e-6, -6e-8, 6e-8, 1e-6]),
                        np.random.default_rng(0).uniform(0, 50, 64)]
                       ).astype(np.float32)
    want = np.asarray(getattr(jkf.get_kernel(name), fn)(jnp.asarray(t)))
    got = getattr(kernels_fn.get_kernel(name), fn)(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert got.dtype == torch.float32


def test_get_kernel_rejects_unknown():
    assert set(kernels_fn.KERNELS) == set(jkf.KERNELS)
    with pytest.raises(ValueError, match="unknown kernel"):
        kernels_fn.get_kernel("cauchy")


# -- Hessian terms, N = 16 ------------------------------------------------------


@pytest.fixture(scope="module")
def hess_setup():
    Y = three_loops(n_per=8, loops=2, dim=6)
    affs = {k: jmake(Y, 5.0, model=k) for k in KINDS}
    X = jax.random.normal(jax.random.PRNGKey(1), (Y.shape[0], 2)) * 0.4
    return affs, X


@pytest.mark.parametrize("fn", ["diag_hessian", "full_hessian",
                                "xx_weights_ii", "lq_matmul"])
@pytest.mark.parametrize("kind", KINDS)
def test_hessian_terms_match_jax(hess_setup, kind, fn):
    affs, X = hess_setup
    want = getattr(jhess, fn)(X, affs[kind], kind, LAMS[kind])
    got = getattr(hessians, fn)(_t(X), _port_aff(affs[kind]), kind,
                                LAMS[kind])
    if want is None:                       # lq_matmul, unnormalized kinds
        assert got is None and kind not in ("ssne", "tsne")
        return
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel_fro(got, want) < 1e-4


@pytest.mark.parametrize("kind", KINDS)
def test_full_hessian_matches_autograd(hess_setup, kind):
    """The port's own faithfulness check, as the reference's against
    jax.hessian: eqs. (2)-(3) assembled from Laplacian blocks equal the
    autograd Hessian of the direct energy (float64), and the diagonal is
    its diagonal."""
    affs, X = hess_setup
    aff = Affinities(*(torch.tensor(np.asarray(w), dtype=torch.float64)
                       for w in affs[kind]))
    X64 = torch.tensor(np.asarray(X), dtype=torch.float64)
    n, d = X64.shape
    H_ad = torch.autograd.functional.hessian(
        lambda Z: direct_energy(Z, aff, kind, LAMS[kind]), X64
    ).reshape(n * d, n * d)
    H = hessians.full_hessian(X64, aff, kind, LAMS[kind])
    assert _rel_fro(H, H_ad) < 1e-4
    assert _rel_fro(hessians.diag_hessian(X64, aff, kind, LAMS[kind])
                    .reshape(-1), torch.diagonal(H_ad)) < 1e-4


# -- batched CG -----------------------------------------------------------------


@pytest.mark.parametrize("tol,maxiter", [(0.1, 50), (1e-3, 50), (1e-6, 6)])
def test_batched_cg_matches_jax(tol, maxiter):
    rng = np.random.default_rng(11)
    d, n = 2, 40
    M = rng.normal(size=(d, n, n))
    B = (M @ M.transpose(0, 2, 1) / n + 0.05 * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(d, n)).astype(np.float32)
    x0 = (0.1 * rng.normal(size=(d, n))).astype(np.float32)
    want = jcg.batched_cg(jnp.asarray(B), jnp.asarray(b), jnp.asarray(x0),
                          tol=tol, maxiter=maxiter)
    got = cg.batched_cg(_t(B), _t(b), _t(x0), tol=tol, maxiter=maxiter)
    assert got.n_iters == int(want.n_iters)
    assert 0 < got.n_iters <= maxiter
    _close(got.x, want.x)
    np.testing.assert_allclose(float(got.rel_residual),
                               float(want.rel_residual), rtol=5e-2)
    if got.n_iters < maxiter:
        assert float(got.rel_residual) <= tol


# -- directions -----------------------------------------------------------------


@pytest.fixture(scope="module")
def dir_setup():
    Y = three_loops(n_per=16, loops=3, dim=8)
    affs = {m: jmake(Y, 8.0, model=m) for m in ("ee", "tsne")}
    X = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                     (Y.shape[0], 2)) * 0.5)
    return affs, X


def _problem(dir_setup, kind):
    affs, X = dir_setup
    jaff = affs["tsne" if kind in ("ssne", "tsne") else "ee"]
    _, G = jeg(jnp.asarray(X), jaff, kind, LAMS[kind])
    return jaff, X, np.asarray(G)


@pytest.mark.parametrize("kind", KINDS)
def test_diagh_direction_matches_jax(dir_setup, kind):
    jaff, X, G = _problem(dir_setup, kind)
    Pj, _ = jstrat.DiagH().direction((), jnp.asarray(X), jnp.asarray(G), jaff,
                                     kind, LAMS[kind])
    ps = DiagH()
    P, state = ps.direction(ps.init(_t(X), _port_aff(jaff), kind,
                                    LAMS[kind]),
                            _t(X), _t(G), _port_aff(jaff), kind, LAMS[kind])
    assert state == ()
    _close(P, Pj)


@pytest.mark.parametrize("kind", KINDS)
def test_sdminus_direction_matches_jax(dir_setup, kind):
    """Two calls: the second is warm-started from the first's direction."""
    jaff, X, G = _problem(dir_setup, kind)
    lam = LAMS[kind]
    js, ps = jstrat.SDMinus(), SDMinus()
    jstate = js.init(jnp.asarray(X), jaff, kind, lam)
    state = ps.init(_t(X), _port_aff(jaff), kind, lam)
    _close(state["Bplus"], jstate["Bplus"], rtol=1e-5, rel_atol=1e-6)
    X2 = X + 0.05 * np.random.default_rng(3).normal(size=X.shape)
    X2 = X2.astype(np.float32)
    _, G2 = jeg(jnp.asarray(X2), jaff, kind, lam)
    for Xk, Gk in ((X, G), (X2, np.asarray(G2))):
        Pj, jstate = js.direction(jstate, jnp.asarray(Xk), jnp.asarray(Gk),
                                  jaff, kind, lam)
        P, state = ps.direction(state, _t(Xk), _t(Gk), _port_aff(jaff),
                                kind, lam)
        Pj, P = np.asarray(Pj), P.numpy()
        _close(P - P.mean(0), Pj - Pj.mean(0))
        assert torch.equal(state["prev_P"], torch.from_numpy(P))


def test_sdminus_blocks_equal_the_reference_formula(dir_setup, monkeypatch):
    """The blocks SD- builds in place and hands to the batched CG are the
    reference's Bplus + 8 (I * rowsum - relu(wxx)) bit for bit."""
    jaff, X, G = _problem(dir_setup, "tsne")
    aff = _port_aff(jaff)
    seen = []

    def spy(B, *args, **kw):
        seen.append(B.clone())
        return cg.batched_cg(B, *args, **kw)

    monkeypatch.setattr(strategies, "batched_cg", spy)
    ps = SDMinus()
    state = ps.init(_t(X), aff, "tsne", 1.0)
    ps.direction(state, _t(X), _t(G), aff, "tsne", 1.0)
    wxx = torch.clamp_min(hessians.xx_weights_ii(_t(X), aff, "tsne", 1.0),
                          0.0)
    n = X.shape[0]
    want = state["Bplus"][None] + 8.0 * (
        torch.eye(n)[None] * torch.sum(wxx, dim=-1)[:, :, None] - wxx)
    assert len(seen) == 1 and torch.equal(seen[0], want)


def _sparse_case(dir_setup, source):
    """(jax aff, port aff, X, zero-mean G) for SparseSD: dense EE affinities
    or the reference's SparseAffinities of the same data."""
    affs, X = dir_setup
    G = np.random.default_rng(5).normal(size=X.shape).astype(np.float32)
    G -= G.mean(axis=0)
    if source == "dense":
        return affs["ee"], _port_aff(affs["ee"]), X, G
    Y = np.asarray(three_loops(n_per=16, loops=3, dim=8))
    js = jsparse_affinities(jnp.asarray(Y), k=10, perplexity=5.0,
                            model="ee", method="exact")
    ps = convert.saff_from_numpy(js.graph.indices, js.graph.weights,
                                 js.rev.indices, js.rev.weights, "cpu")
    return js, ps, X, G


# SparseSD's system B = 4 L(W+_k) + resid + mu I is near-singular along the
# constant vector (eigenvalue ~mu).  Jacobi-PCG mixes that mode into the
# others, so the rounding of a gradient's column sums and of the degrees
# (the port and JAX sum in other orders) is amplified by up to 1/mu in the
# whole direction, not only in its mean.  With the full graph (k = N - 1)
# the 1e-5 default leaves a 1.6e-3 gap, so those cases run at
# mu_scale = 1e-3, as the sparse backend's exact-count parity tests do
# (ROADMAP.md, Queue 3); k = 0 and k = 7 hold at the default.
@pytest.mark.parametrize("source,k,mu_scale", [
    ("dense", 0, 1e-5), ("dense", 7, 1e-5), ("dense", 7, 1e-3),
    ("dense", -1, 1e-3), ("sparse", -1, 1e-3)])
def test_sparsesd_direction_matches_jax(dir_setup, source, k, mu_scale):
    jaff, paff, X, G = _sparse_case(dir_setup, source)
    js = jstrat.make_strategy("sparsesd", k=k, mu_scale=mu_scale)
    ps = make_strategy("sparsesd", k=k, mu_scale=mu_scale)
    assert isinstance(ps, SparseSD)
    jstate = js.init(jnp.asarray(X), jaff, "ee", 50.0)
    state = ps.init(_t(X), paff, "ee", 50.0)
    _close(state["inv_diag"], jstate["inv_diag"], rtol=1e-5, rel_atol=1e-6)
    # the shift holds mu and the clipped degree rounding 4 (dfull - dsym):
    # compared at the rounding of the degrees, B's diagonal
    np.testing.assert_allclose(
        state["shift"].numpy(), np.asarray(jstate["shift"]), rtol=1e-5,
        atol=1e-6 / float(np.min(np.asarray(jstate["inv_diag"]))))
    assert tuple(state["indices"].shape) == tuple(jstate["indices"].shape)
    # two calls: the second warm-starts from the first
    for Gk in (G, 0.5 * G[::-1].copy()):
        Pj, jstate = js.direction(jstate, jnp.asarray(X), jnp.asarray(Gk),
                                  jaff, "ee", 50.0)
        P, state = ps.direction(state, _t(X), _t(Gk), paff, "ee", 50.0)
        Pj, P = np.asarray(Pj), P.numpy()
        _close(P - P.mean(0), Pj - Pj.mean(0))


def test_sparsesd_k0_is_fp(dir_setup):
    """k = 0: an all-padding graph, so B = 4 D+ + mu I — the FP direction
    (with SparseSD's mu) up to the PCG tolerance."""
    jaff, paff, X, G = _sparse_case(dir_setup, "dense")
    ps = SparseSD(k=0)
    state = ps.init(_t(X), paff, "ee", 50.0)
    assert state["indices"].shape == (X.shape[0], 1)
    assert not bool(state["weights"].any())
    P, _ = ps.direction(state, _t(X), _t(G), paff, "ee", 50.0)
    want = -_t(G) / (4.0 * paff.Wp.sum(-1, keepdim=True)
                     + (state["shift"] - 4.0 * paff.Wp.sum(-1))[:, None])
    _close(P, want, rtol=1e-3, rel_atol=1e-3)


def _lbfgs_sequence(X0, G0, steps=5):
    """Iterates X_k and gradients G_k of a fixed quadratic-plus-noise, with
    one step whose (s, y) pair fails the curvature guard (y = -s)."""
    rng = np.random.default_rng(9)
    A = rng.uniform(0.5, 2.0, size=X0.shape).astype(np.float32)
    seq = [(X0, G0)]
    X = X0
    for k in range(steps):
        Xn = (X - 0.1 * A * X + 0.02 * rng.normal(size=X.shape)
              ).astype(np.float32)
        Gn = (A * Xn).astype(np.float32)
        if k == 2:      # s^T y < 0: rejected by the guard
            Gn = (seq[-1][1] - (Xn - X)).astype(np.float32)
        seq.append((Xn, Gn))
        X = Xn
    return seq


@pytest.mark.parametrize("m", [100, 2])
def test_lbfgs_directions_match_jax(dir_setup, m):
    """Six calls: the buffer fills (and, with m = 2, wraps around), one pair
    is refused by the curvature guard."""
    _, X = dir_setup
    seq = _lbfgs_sequence(X, np.asarray(X) * 2.0)
    js, ps = jbase.LBFGS(m=m), LBFGS(m=m)
    jstate = js.init(jnp.asarray(X), None, "ee", 1.0)
    state = ps.init(_t(X), None, "ee", 1.0)
    for Xk, Gk in seq:
        Pj, jstate = js.direction(jstate, jnp.asarray(Xk), jnp.asarray(Gk),
                                  None, "ee", 1.0)
        P, state = ps.direction(state, _t(Xk), _t(Gk), None, "ee", 1.0)
        _close(P, Pj, rtol=1e-5, rel_atol=1e-6)
        assert int(state["count"]) == int(jstate["count"])
        assert int(state["head"]) == int(jstate["head"])
    assert int(state["count"]) == min(m, len(seq) - 2)   # one refused
    _close(state["rho"], jstate["rho"], rtol=1e-5, rel_atol=1e-6)


def test_lbfgs_first_call_is_minus_g(dir_setup):
    """The first call pushes nothing and returns -G itself."""
    _, X = dir_setup
    G = torch.randn(X.shape, generator=torch.Generator().manual_seed(0))
    ps = LBFGS()
    P, state = ps.direction(ps.init(_t(X), None, "ee", 1.0), _t(X), G, None,
                            "ee", 1.0)
    assert torch.equal(P, -G) and state["started"]
    assert int(state["count"]) == 0 and state["pushes"] == 0


def test_nonlinear_cg_directions_match_jax(dir_setup):
    """Three calls: -G first, then PR+ updates; the third is built to lose
    descent and restarts at -G."""
    _, X = dir_setup
    rng = np.random.default_rng(4)
    G1 = rng.normal(size=X.shape).astype(np.float32)
    G2 = (0.6 * G1 + 0.3 * rng.normal(size=X.shape)).astype(np.float32)
    G3 = (-3.0 * G2).astype(np.float32)
    js, ps = jbase.NonlinearCG(), NonlinearCG()
    jstate = js.init(jnp.asarray(X), None, "ee", 1.0)
    state = ps.init(_t(X), None, "ee", 1.0)
    for k, Gk in enumerate((G1, G2, G3)):
        Pj, jstate = js.direction(jstate, jnp.asarray(X), jnp.asarray(Gk),
                                  None, "ee", 1.0)
        P, state = ps.direction(state, _t(X), _t(Gk), None, "ee", 1.0)
        _close(P, Pj, rtol=1e-6, rel_atol=1e-7)
        if k == 0:
            assert torch.equal(P, -_t(Gk))
        assert float(torch.sum(P * _t(Gk))) < 0


def test_make_strategy_names_match_jax():
    assert set(strategies.STRATEGIES) == set(jstrat.STRATEGIES)
    for name, cls in strategies.STRATEGIES.items():
        assert cls.__name__ == jstrat.STRATEGIES[name].__name__
        assert isinstance(make_strategy(name.upper()), cls)
    assert baselines.LBFGS().m == jbase.LBFGS().m == 100
    with pytest.raises(ValueError, match="unknown strategy"):
        make_strategy("newton")
