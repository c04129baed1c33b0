"""The port's sparse neighbour-graph backend against the JAX reference.

Each part of `repro_torch.sparse`, the sparse half of
`repro_torch.core.objectives` and the whole sparse fit runs on the CPU beside
its `repro` counterpart on the same numpy inputs.  The reference's random
draws (kNN projection directions, the spectral start block, the negatives'
cyclic shifts) are computed with `jax.random` here and handed to the port,
which takes each as an argument.  Tolerances are those of the reference's
own tests: sorted kNN distances at rtol 1e-5 (tests/test_sparse.py:363),
Laplacian products at rtol 5e-5 / atol 5e-6 (tests/test_sparse_kernel.py:
71-72), CG solutions at rtol 1e-3 / atol 1e-4 (tests/test_sparse.py:283-285),
energy and gradient at 1e-5 relative (tests/test_sparse.py:143-149) and
energy traces at rtol 1e-4 (tests/test_api.py:92).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.core import energy_and_grad_sparse as jeg_sparse
from repro.core import make_affinities as jmake_affinities
from repro.embed.trainer import _sparse_spectral_init as jspectral_init
from repro.sparse import NeighborGraph as JGraph
from repro.sparse import calibrated_weights_ell as jcalibrate
from repro.sparse import from_dense as jfrom_dense
from repro.sparse import knn_graph as jknn
from repro.sparse import make_sd_operator as jsd_operator
from repro.sparse import pcg as jpcg
from repro.sparse import reverse_graph as jreverse
from repro.sparse import sparse_affinities as jsparse_affinities
from repro.sparse import sparse_laplacian_eigenmaps as jeigenmaps
from repro.sparse import sym_lap_matvec as jsym_lap
from repro.sparse import to_dense as jto_dense
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec
from repro_torch.core.objectives import energy_and_grad_sparse
from repro_torch.kernels import ops
from repro_torch.sparse import (NeighborGraph, calibrated_weights_ell,
                                from_dense, knn_graph, make_sd_operator, pcg,
                                reverse_graph, sparse_affinities,
                                sparse_laplacian_eigenmaps, sym_lap_matvec,
                                to_dense)
from tests.conftest import three_loops

LAMS = {"ee": 50.0, "ssne": 5.0, "tsne": 2.0, "tee": 10.0, "epan": 5.0}

# The sparse SD system B = 4 L(W+) + mu I is near-singular along the
# constant vector (eigenvalue mu = mu_scale mean(diag B)).  A gradient's
# column sums are zero only up to float32 rounding, which differs with the
# order of the sums (~1e-8 of |G|), and CG amplifies that component by up to
# 1/mu.  At the default mu_scale = 1e-5 this parts the reference from
# itself: its jnp and Pallas-interpret paths take different PCG counts from
# the first iteration and their energy traces part by a few 1e-5 within
# five iterations (test_sparse_fit_trace_at_default_mu_scale holds the port
# to that spread).  At mu_scale = 1e-3 the noise stays below the
# tolerances, so the exact CG-count and whole-fit comparisons run there
# (ROADMAP.md, Queue 3).
MU_SCALE = 1e-3


def _problem(n=41, d_hi=6, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(n, d_hi)).astype(np.float32)
    X = (0.5 * rng.normal(size=(n, 2))).astype(np.float32)
    return Y, X


def _t(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def _port_saff(saff):
    return convert.saff_from_numpy(saff.graph.indices, saff.graph.weights,
                                   saff.rev.indices, saff.rev.weights, "cpu")


def _jax_shifts(seed, it, n, m):
    """The reference's draw of iteration `it` (core/objectives.py:268 under
    the engine's fold_in(PRNGKey(seed), it), engine.py:283,357)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
    return 1 + jax.random.choice(key, n - 1, shape=(m,), replace=False)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


# -- graph construction ---------------------------------------------------------


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_knn_matches_jax(method):
    """Sorted distances at rtol 1e-5; the first k index sets wherever the
    gap to the (k+1)-th neighbour exceeds that tolerance.  The approximate
    search gets the reference's projection directions.  Standard-normal data,
    as in the reference's kNN test: the Gram-identity distances of
    far-from-origin data cancel digits in either package."""
    Y, _ = _problem(n=80)
    k = 6
    kw = dict(block_rows=16)
    pkw = dict(kw)
    if method == "approx":
        kw.update(n_projections=8, window=12, seed=3)
        keys = jax.random.split(jax.random.PRNGKey(3), 8)
        U = jnp.stack([jax.random.normal(kk, (Y.shape[1],)) for kk in keys])
        pkw.update(n_projections=8, window=12, projections=_t(U))
    jd2, jidx = jknn(jnp.asarray(Y), k + 1, method=method, **kw)
    d2, idx = knn_graph(_t(Y), k + 1, method=method, **pkw)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (Y.shape[0], k + 1)
    jd2, jidx = np.asarray(jd2), np.asarray(jidx)
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-5, atol=1e-6)
    clear = jd2[:, k] - jd2[:, k - 1] > 1e-5 * jd2[:, k]
    assert clear.mean() > 0.9
    for i in np.flatnonzero(clear):
        assert set(idx[i, :k].tolist()) == set(jidx[i, :k].tolist()), i


def test_calibrated_weights_match_jax():
    Y, _ = _problem()
    jd2, jidx = jknn(jnp.asarray(Y), 10, method="exact")
    valid = jidx != jnp.arange(Y.shape[0])[:, None]
    want = np.asarray(jcalibrate(jd2, valid, 5.0))
    got = calibrated_weights_ell(_t(jd2), _t(valid), 5.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("model", ["ee", "tsne"])
def test_sparse_affinities_match_jax(model):
    Y, _ = _problem()
    js = jsparse_affinities(jnp.asarray(Y), k=10, perplexity=5.0, model=model)
    timings = {}
    ps = sparse_affinities(_t(Y), k=10, perplexity=5.0, model=model,
                           timings=timings)
    assert set(timings) == {"knn_s", "calibrate_s", "reverse_s"}
    for jg, g in ((js.graph, ps.graph), (js.rev, ps.rev)):
        np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
        np.testing.assert_allclose(g.weights.numpy(), np.asarray(jg.weights),
                                   rtol=1e-5, atol=1e-9)


def test_reverse_graph_and_dense_conversions_match_jax():
    """reverse_graph on a graph with repeated columns and padding slots
    (widths and slot order included); from_dense / to_dense."""
    rng = np.random.default_rng(5)
    n, k = 30, 5
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    idx[:, 0] = idx[:, 1]                       # repeated columns
    idx[::4, 2], w[::4, 2] = np.arange(0, n, 4), 0.0   # padding slots
    jr = jreverse(JGraph(jnp.asarray(idx), jnp.asarray(w)))
    r = reverse_graph(NeighborGraph(_t(idx), _t(w)))
    np.testing.assert_array_equal(r.indices.numpy(), np.asarray(jr.indices))
    np.testing.assert_array_equal(r.weights.numpy(), np.asarray(jr.weights))
    np.testing.assert_allclose(
        to_dense(NeighborGraph(_t(idx), _t(w))).numpy(),
        np.asarray(jto_dense(JGraph(jnp.asarray(idx), jnp.asarray(w)))),
        rtol=1e-6, atol=1e-9)
    Wp = np.asarray(jmake_affinities(jnp.asarray(_problem(n=20)[0]), 6.0).Wp)
    Wp = np.where(Wp > np.median(Wp), Wp, 0.0).astype(np.float32)
    jg = jfrom_dense(jnp.asarray(Wp), k=8)
    g = from_dense(_t(Wp), k=8)
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_array_equal(g.weights.numpy(), np.asarray(jg.weights))
    full = from_dense(_t(Wp), k=19)
    np.testing.assert_allclose(to_dense(full).numpy(), Wp, rtol=1e-6,
                               atol=1e-9)


# -- operators, CG, spectral start ----------------------------------------------


def _jax_graph_problem(model="ee"):
    Y, X = _problem()
    js = jsparse_affinities(jnp.asarray(Y), k=10, perplexity=5.0, model=model)
    return js, _port_saff(js), X


@pytest.mark.parametrize("with_rev", [True, False])
def test_sym_lap_matvec_and_sd_operator_match_jax(with_rev):
    js, ps, X = _jax_graph_problem()
    jrev = js.rev if with_rev else None
    prev = ps.rev if with_rev else None
    want = np.asarray(jsym_lap(js.graph, jnp.asarray(X), rev=jrev))
    got = sym_lap_matvec(ps.graph, _t(X), rev=prev)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-6)
    assert ops.last_dispatch("ell_lap_matvec")["path"] == "torch"
    jmv, jinv, jmu = jsd_operator(js.graph, jrev, 1e-5)
    mv, inv, mu = make_sd_operator(ps.graph, prev, 1e-5)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-5)
    np.testing.assert_allclose(float(mu), float(jmu), rtol=1e-5)
    np.testing.assert_allclose(mv(_t(X)).numpy(), np.asarray(jmv(
        jnp.asarray(X))), rtol=5e-5, atol=5e-6)


@pytest.mark.parametrize("tol,maxiter", [(1e-3, 100), (1e-6, 400), (1e-9, 7)])
def test_pcg_matches_jax(tol, maxiter):
    """The same iteration count (the host loop stops where the device
    while_loop stops) and the same solution, for a right-hand side with
    zero column sums, as a gradient's (see MU_SCALE)."""
    js, ps, X = _jax_graph_problem()
    B = np.random.default_rng(9).normal(size=X.shape).astype(np.float32)
    B -= B.mean(axis=0)
    jmv, jinv, _ = jsd_operator(js.graph, js.rev, MU_SCALE)
    mv, inv, _ = make_sd_operator(ps.graph, ps.rev, MU_SCALE)
    jr = jpcg(jmv, jnp.asarray(B), jnp.zeros_like(jnp.asarray(B)),
              inv_diag=jinv, tol=tol, maxiter=maxiter)
    r = pcg(mv, _t(B), torch.zeros(B.shape), inv_diag=inv, tol=tol,
            maxiter=maxiter)
    assert r.n_iters == int(jr.n_iters)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(float(r.rel_residual),
                               float(jr.rel_residual), rtol=1e-2)


def test_sparse_eigenmaps_match_jax_with_injected_start():
    """The reference's own starting block (linalg.py:141) handed to the port;
    each embedding column matches up to sign."""
    Y = np.array(three_loops(n_per=30, loops=2, dim=8), dtype=np.float32)
    js = jsparse_affinities(jnp.asarray(Y), k=12, perplexity=4.0, model="ee")
    n = Y.shape[0]
    V0 = jax.random.normal(jax.random.PRNGKey(0), (n, 9))
    want = np.asarray(jeigenmaps(js.graph, js.rev, d=2, seed=0))
    got = sparse_laplacian_eigenmaps(_port_saff(js).graph, _port_saff(js).rev,
                                     d=2, V0=_t(V0)).numpy()
    for j in range(2):
        sign = np.sign(np.dot(got[:, j], want[:, j]))
        np.testing.assert_allclose(sign * got[:, j], want[:, j], atol=1e-3)


# -- energy and gradient --------------------------------------------------------


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", sorted(LAMS))
def test_energy_and_grad_sparse_matches_jax(kind, sampled):
    """Exhaustive negatives, and sampled ones with the reference's draw; the
    line-search fast path and, for the normalized kinds, the streaming z."""
    js, ps, X = _jax_graph_problem(model=kind)
    lam = LAMS[kind]
    n = X.shape[0]
    m = 6 if sampled else None
    key = jax.random.PRNGKey(3) if sampled else None
    shifts = (1 + jax.random.choice(key, n - 1, shape=(m,), replace=False)
              if sampled else None)
    pshifts = _t(shifts) if sampled else None
    E1, G1 = jeg_sparse(jnp.asarray(X), js, kind, lam, n_negatives=m, key=key)
    E2, G2 = energy_and_grad_sparse(_t(X), ps, kind, torch.tensor(lam),
                                    n_negatives=m, shifts=pshifts)
    assert abs(float(E2) - float(E1)) <= 1e-5 * abs(float(E1))
    assert _rel(G2.numpy(), G1) <= 1e-5
    E3, none = energy_and_grad_sparse(_t(X), ps, kind, torch.tensor(lam),
                                      n_negatives=m, shifts=pshifts,
                                      with_grad=False)
    assert none is None and float(E3) == float(E2)
    if kind in ("ssne", "tsne"):
        z_prev = jnp.asarray(0.7 * float(E1) ** 2 + 1.0)
        _, _, jz = jeg_sparse(jnp.asarray(X), js, kind, lam, n_negatives=m,
                              key=key, z_prev=z_prev, z_decay=0.8,
                              return_state=True)
        _, _, z = energy_and_grad_sparse(
            _t(X), ps, kind, torch.tensor(lam), n_negatives=m,
            shifts=pshifts, z_prev=_t(z_prev), z_decay=0.8,
            return_state=True)
        np.testing.assert_allclose(float(z), float(jz), rtol=1e-5)
    else:
        with pytest.raises(ValueError, match="normalized"):
            energy_and_grad_sparse(_t(X), ps, kind, 1.0, n_negatives=None,
                                   return_state=True)
    if sampled:
        with pytest.raises(ValueError, match="shifts"):
            energy_and_grad_sparse(_t(X), ps, kind, 1.0, n_negatives=m)


def test_sparse_gradient_ell_products_take_impl():
    """The gradient's ELL products (la_x) go through the dispatcher with the
    caller's impl: "kernel" needs CUDA tensors, so it raises on the CPU,
    and "torch" runs the plain version.  The energy alone (no la_x) and
    t-SNE's K-reweighted la_x (no ELL kernel) do not reach it."""
    js, ps, X = _jax_graph_problem()
    with pytest.raises(ValueError, match="CUDA"):
        energy_and_grad_sparse(_t(X), ps, "ee", 1.0, n_negatives=None,
                               impl="kernel")
    energy_and_grad_sparse(_t(X), ps, "ee", 1.0, n_negatives=None,
                           with_grad=False, impl="kernel")
    energy_and_grad_sparse(_t(X), ps, "tsne", 1.0, n_negatives=None,
                           impl="kernel")
    energy_and_grad_sparse(_t(X), ps, "ee", 1.0, n_negatives=None,
                           impl="torch")
    assert ops.last_dispatch("ell_lap_matvec")["reason"] == "forced-off"


# -- the whole sparse fit -------------------------------------------------------


def _fit_pair(kind, lam, strategy="sd", iters=5, mu_scale=MU_SCALE,
              jax_impl="jnp"):
    """The JAX sparse fit (ELL products by `jax_impl`) and the port's, from
    JAX's affinities and start (carried by convert.py) with JAX's
    per-iteration draws."""
    Y = np.array(three_loops(n_per=24, loops=3, dim=8), dtype=np.float32)
    jspec = JEmbedSpec(kind=kind, lam=lam, strategy=strategy,
                       backend="sparse", perplexity=8.0, max_iters=iters,
                       tol=0.0, n_neighbors=20, n_negatives=8,
                       mu_scale=mu_scale, kernel_impl=jax_impl)
    js = jsparse_affinities(jnp.asarray(Y), k=20, perplexity=8.0, model=kind)
    X0 = jspectral_init(jspec, js, Y.shape[0])
    jd, pd = [], []
    jres = JEmbedding(jspec).fit(None, X0=X0, saff=js,
                                 callback=lambda it, X, e, d: jd.append(d)
                                 ).result_
    spec = convert.spec_from_jax_fields(dataclasses.asdict(jspec))
    n, m = Y.shape[0], spec.n_negatives
    emb = Embedding(spec, device="cpu").fit(
        None, X0=convert.embedding_from_numpy(X0, "cpu"),
        saff=_port_saff(js),
        shift_source=lambda seed, it: _t(_jax_shifts(seed, it, n, m)),
        callback=lambda it, X, e, d: pd.append(d))
    return jres, jd, emb, pd


@pytest.mark.parametrize("kind,lam", [("ee", 50.0), ("tsne", 1.0)])
def test_sparse_fit_trace_matches_jax(kind, lam):
    jres, jd, emb, pd = _fit_pair(kind, lam)
    res = emb.result_
    assert emb.backend_ == "sparse" and res.n_iters == jres.n_iters == 5
    np.testing.assert_allclose(res.energies, jres.energies, rtol=1e-4)
    assert [d["pcg_iters"] for d in pd] == [d["pcg_iters"] for d in jd]
    np.testing.assert_array_equal(res.n_fevals, jres.n_fevals)
    np.testing.assert_allclose(res.step_sizes, jres.step_sizes, rtol=1e-4)
    assert res.energies[-1] < res.energies[0]
    if kind == "tsne":
        np.testing.assert_allclose([d["z_ema"] for d in pd],
                                   [d["z_ema"] for d in jd], rtol=1e-4)


@pytest.mark.parametrize("kind,lam", [("ee", 50.0), ("tsne", 1.0)])
def test_sparse_fit_trace_at_default_mu_scale(kind, lam):
    """At the default mu_scale = 1e-5 (see MU_SCALE) the port's energy trace
    stays within rtol 1e-4 of the reference's jnp path, and within 3x of the
    reference's own spread: how far its Pallas-interpret path (the same
    float32 sums in another order) parts from its jnp path.  PCG counts are
    not compared: the reference's two paths differ there already."""
    jres, _, emb, _ = _fit_pair(kind, lam, mu_scale=1e-5)
    ires, _, _, _ = _fit_pair(kind, lam, mu_scale=1e-5,
                              jax_impl="pallas-interpret")
    want = np.asarray(jres.energies)
    got = emb.result_.energies
    assert emb.result_.n_iters == jres.n_iters == ires.n_iters == 5
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    port = float(np.max(np.abs(got - want) / np.abs(want)))
    spread = float(np.max(np.abs(np.asarray(ires.energies) - want)
                          / np.abs(want)))
    print(f"{kind} mu_scale=1e-5: port vs jnp {port:.2e}, "
          f"Pallas-interpret vs jnp {spread:.2e}")
    assert spread > 1e-5, spread      # the reference drifts at this mu
    assert port <= 3.0 * spread, (port, spread)
    assert got[-1] < got[0]


@pytest.mark.parametrize("strategy", ["fp", "gd"])
def test_sparse_diagonal_strategies_descend(strategy):
    jres, _, emb, pd = _fit_pair("ee", 1.0, strategy=strategy, iters=8)
    e = emb.result_.energies
    assert np.all(np.isfinite(e)) and e[-1] < e[0]
    assert "pcg_iters" not in pd[0]
    np.testing.assert_allclose(e, jres.energies, rtol=1e-4)


def test_sparse_backend_rejects_what_it_cannot_take():
    js, ps, X = _jax_graph_problem()
    spec = EmbedSpec(kind="ee", backend="sparse", perplexity=5.0,
                     max_iters=2)
    with pytest.raises(ValueError, match="dense-backend-only"):
        Embedding(spec, device="cpu").fit(
            None, aff=jmake_affinities(jnp.asarray(_problem()[0]), 5.0))
    with pytest.raises(ValueError, match="rows"):
        Embedding(spec, device="cpu").fit(np.zeros((7, 3), np.float32),
                                          saff=ps)
    with pytest.raises(ValueError, match="n_neighbors"):
        Embedding(spec.replace(n_neighbors=3), device="cpu").fit(
            _problem()[0])
    with pytest.raises(ValueError, match="sparse backend"):
        Embedding(spec.replace(backend="dense"), device="cpu").fit(
            None, saff=ps)
    from repro_torch.embed.trainer import build_sparse_objective
    with pytest.raises(ValueError, match="sparse-sharded backend needs a "
                                         "mesh"):
        build_sparse_objective(spec, saff=ps, sharded=True, device="cpu")
