"""The port's core modules (repro_torch.core) against the JAX reference.

Inputs are made with numpy from a seed and go through the JAX function and
its port.  Tolerances, with their reasons:

  * affinities: rtol 1e-4, atol 1e-5 * max(W) — the 60-step bisection
    follows the same path; exp/log/sum rounding differs between XLA and
    PyTorch (observed ~2e-6 of max);
  * spectral start: per column up to sign, atol 5e-4 on unit-std columns —
    eigenvectors from two LAPACK builds agree to eps * |M| / eigengap
    (observed ~6e-5);
  * energy and gradient: the kernel tolerances of
    tests/test_kernels_pairwise.py (5e-5 with atol scaled by max|G|, energy
    at rtol 1e-4);
  * directions: rtol 1e-4 with atol scaled by max|P| (triangular solves in
    another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import laplacian as jlap
from repro.core import linesearch as jls
from repro.core import objectives as jobj
from repro.core import strategies as jstrat
from repro.core.affinities import Affinities as JAff
from repro.core.affinities import make_affinities as jmake
from repro.core.spectral_init import laplacian_eigenmaps as jeig
from repro_torch.core import laplacian, linesearch, objectives, strategies
from repro_torch.core.affinities import (Affinities, calibrated_conditionals,
                                         make_affinities, sq_distances)
from repro_torch.core.spectral_init import laplacian_eigenmaps
from repro_torch.data import coil_like
from repro_torch.kernels.ref import KINDS

LAMS = {"ee": 50.0, "ssne": 1.0, "tsne": 1.0, "tee": 10.0, "epan": 10.0}


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, want, rtol=1e-4, rel_atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel_atol * (np.abs(want).max() + 1e-30))


@pytest.fixture(scope="module")
def data():
    return coil_like(n_per=20, loops=3, dim=12, seed=1)


@pytest.fixture(scope="module")
def jax_aff(data):
    return {m: jmake(jnp.asarray(data), 10.0, model=m) for m in ("ee", "tsne")}


def _port_aff(jaff):
    return Affinities(_t(jaff.Wp), _t(jaff.Wm))


@pytest.mark.parametrize("model", ["ee", "tsne"])
def test_make_affinities_matches_jax(data, jax_aff, model):
    got = make_affinities(torch.from_numpy(data), 10.0, model=model)
    _close(got.Wp, jax_aff[model].Wp)
    assert torch.equal(got.Wm, _t(jax_aff[model].Wm))
    assert torch.all(torch.diagonal(got.Wp) == 0)


def test_calibrated_conditionals_chunking_is_exact(data):
    """Row chunks calibrate independently: any chunk size gives the same P."""
    D2 = sq_distances(torch.from_numpy(data))
    whole = calibrated_conditionals(D2, 10.0)
    chunked = calibrated_conditionals(D2, 10.0, chunk_rows=7)
    assert torch.equal(whole, chunked)
    np.testing.assert_allclose(whole.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("model", ["ee", "tsne"])
def test_laplacian_eigenmaps_matches_jax_up_to_sign(jax_aff, model):
    Wp = jax_aff[model].Wp
    want = np.asarray(jeig(Wp, 2))
    got = laplacian_eigenmaps(_t(Wp), 2).numpy()
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, atol=5e-4)


@pytest.mark.parametrize("kappa", [0, 3, 7, 100])
def test_sparsified_attractive_matrix_matches_jax(jax_aff, kappa):
    Wp = jax_aff["ee"].Wp
    got = laplacian.sparsified_attractive_matrix(_t(Wp), kappa)
    _close(got, jlap.sparsified_attractive_matrix(Wp, kappa), rel_atol=1e-6)


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_laplacian_helpers_match_jax(jax_aff, mode):
    Wp = jax_aff["ee"].Wp
    X = np.random.default_rng(0).normal(size=(Wp.shape[0], 2))
    _close(laplacian.laplacian_matmul(_t(Wp), _t(X)),
           jlap.laplacian_matmul(Wp, jnp.asarray(X, jnp.float32)))
    _close(laplacian.symmetrize(_t(Wp) * 2, mode), jlap.symmetrize(Wp * 2, mode))
    _close(laplacian.knn_sparsify(_t(Wp), 5, mode),
           jlap.knn_sparsify(Wp, 5, mode))


@pytest.mark.parametrize("kind", KINDS)
def test_energy_and_grad_matches_jax(jax_aff, kind):
    model = "tsne" if kind in ("ssne", "tsne") else "ee"
    jaff = jax_aff[model]
    X = np.random.default_rng(3).normal(size=(jaff.Wp.shape[0], 2)) * 0.5
    e, g = objectives.energy_and_grad(_t(X), _port_aff(jaff), kind,
                                      LAMS[kind])
    ej, gj = jobj.energy_and_grad(jnp.asarray(X, jnp.float32), jaff, kind,
                                  LAMS[kind])
    np.testing.assert_allclose(float(e), float(ej), rtol=1e-4)
    _close(g, gj, rtol=5e-5, rel_atol=5e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_laplacian_gradient_matches_autograd(jax_aff, kind):
    """grad = 4 L(w) X equals autograd of the textbook energy, and the
    gradient weights reproduce it (paper eqs. (2)-(3))."""
    model = "tsne" if kind in ("ssne", "tsne") else "ee"
    aff = _port_aff(jax_aff[model])
    aff64 = Affinities(aff.Wp.double(), aff.Wm.double())
    X = torch.from_numpy(
        np.random.default_rng(4).normal(size=(aff.Wp.shape[0], 2)) * 0.5)
    Xg = X.clone().requires_grad_(True)
    objectives.direct_energy(Xg, aff64, kind, LAMS[kind]).backward()
    g = objectives.grad(X.float(), aff, kind, LAMS[kind])
    _close(g, Xg.grad.numpy(), rtol=1e-4, rel_atol=1e-4)
    w = objectives.gradient_weights(X, aff64, kind, LAMS[kind])
    _close(g, 4.0 * laplacian.laplacian_matmul(w, X), rtol=1e-4,
           rel_atol=1e-4)


@pytest.mark.parametrize("kappa", [-1, 7])
def test_sd_direction_matches_jax(jax_aff, kappa):
    jaff = jax_aff["ee"]
    # zero column sums, like every gradient 4 L(w) X: a mean would be
    # amplified by 1/mu along B's near-null constant mode
    G = np.random.default_rng(5).normal(size=(jaff.Wp.shape[0], 2))
    G -= G.mean(axis=0)
    js = jstrat.SD(kappa=kappa)
    jstate = js.init(None, jaff, "ee", 50.0)
    Pj, _ = js.direction(jstate, None, jnp.asarray(G, jnp.float32), jaff,
                         "ee", 50.0)
    ps = strategies.SD(kappa=kappa)
    state = ps.init(None, _port_aff(jaff), "ee", 50.0)
    _close(state["B"], jstate["B"], rel_atol=1e-6)
    P, _ = ps.direction(state, None, _t(G), _port_aff(jaff), "ee", 50.0)
    # compared without the column means: the translation mode, which 1/mu
    # amplifies from the rounding of G's sums and which no energy sees
    Pj = np.asarray(Pj)
    P = P.numpy()
    _close(P - P.mean(0), Pj - Pj.mean(0), rtol=1e-4, rel_atol=1e-4)


@pytest.mark.parametrize("name", ["GD", "FP"])
def test_diagonal_directions_match_jax(jax_aff, name):
    jaff = jax_aff["ee"]
    G = np.random.default_rng(6).normal(size=(jaff.Wp.shape[0], 2))
    js, ps = getattr(jstrat, name)(), getattr(strategies, name)()
    Pj, _ = js.direction(js.init(None, jaff, "ee", 1.0), None,
                         jnp.asarray(G, jnp.float32), jaff, "ee", 1.0)
    P, _ = ps.direction(ps.init(None, _port_aff(jaff), "ee", 1.0), None,
                        _t(G), _port_aff(jaff), "ee", 1.0)
    _close(P, Pj, rtol=1e-6, rel_atol=1e-7)


@pytest.mark.parametrize("alpha0", [1.0, 4.0, 1e-3])
def test_backtracking_matches_jax(alpha0):
    """The host-loop line search accepts the step the reference's
    while_loop accepts, after as many evaluations."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(10, 2)).astype(np.float32)
    G = 2 * X
    cfg = dict(c1=1e-4, rho=0.5, max_backtracks=5)

    def ej(Z):
        return jnp.sum(Z * Z) + jnp.sum(jnp.cos(3 * Z))

    def et(Z):
        return torch.sum(Z * Z) + torch.sum(torch.cos(3 * Z))

    want = jls.backtracking(ej, jnp.asarray(X), ej(jnp.asarray(X)),
                            jnp.asarray(G), -jnp.asarray(G),
                            jnp.float32(alpha0), jls.LSConfig(**cfg))
    got = linesearch.backtracking(et, _t(X), et(_t(X)), _t(G), -_t(G),
                                  torch.tensor(alpha0),
                                  linesearch.LSConfig(**cfg))
    assert float(got.alpha) == float(want.alpha)
    assert got.n_evals == int(want.n_evals)
    assert got.success == bool(want.success)
    np.testing.assert_allclose(float(got.e_new), float(want.e_new), rtol=1e-6)


def test_attractive_weights_and_kind_validation(jax_aff):
    aff = _port_aff(jax_aff["tsne"])
    assert objectives.attractive_weights(aff, "tsne") is aff.Wp
    assert objectives.is_normalized("tsne") and not objectives.is_normalized("ee")
    with pytest.raises(ValueError, match="kind"):
        objectives.is_normalized("sne")
    assert isinstance(jax_aff["ee"], JAff)
