"""The port's out-of-sample transform (repro_torch.api.transform, the
cross-set kNN of repro_torch.sparse.graph and TransformSpec) against the JAX
reference.

The same numpy inputs go through `repro` (JAX on the CPU) and the port
(``device="cpu"``).  JAX's random draws are handed to the port: the
approximate cross-kNN's projection directions (`projections=`) and the
sampled anchors (`anchor_source(seed, it)`, JAX's
`choice(fold_in(PRNGKey(seed), it), n_train, (m,), replace=False)`).
Tolerances are the reference's own: kNN distances at rtol 1e-5
(tests/test_sparse.py:355-365), calibrated weights as
tests/test_torch_sparse.py::test_calibrated_weights_match_jax, energy and
gradient at 1e-5 relative (tests/test_sparse.py:143-149), energy traces at
rtol 1e-4 (tests/test_api.py:92) and rowwise coordinates at atol 1e-5
(tests/test_api.py:441,445).

The fixed-anchor EE problem amplifies a last-bit difference: the
reference's own rowwise solve moves by up to 7e-4 when its calibrated
weights are scaled by (1 + 1e-6), for the problem of the reference's batch
invariance test (lambda = 10, a 10-iteration fit) and even at lambda = 1
from a 10- or 30-iteration fit (1e-4 to 1.5e-3); t-SNE stays within 3e-6.
So the port-against-JAX coordinates hold on EE at lambda = 1 from a
50-iteration fit, where the reference moves by at most 6.2e-6 under that
perturbation, and the solver comparisons hand the port JAX's neighbours,
weights and starting points; the batch-invariance test, which compares the
port with itself, keeps the reference's problem.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.api import TransformObjective as JTransformObjective
from repro.api import TransformSpec as JTransformSpec
from repro.api.transform import _anchor_affinities as janchor_affinities
from repro.api.transform import rowwise_transform as jrowwise
from repro.data import mnist_like
from repro.sparse import knn_cross as jknn_cross
from repro_torch import convert
from repro_torch.api import (Embedding, EmbedSpec, TransformObjective,
                             TransformSpec, resolve_transform_spec)
from repro_torch.api.transform import (ROW_BLOCK, _anchor_affinities,
                                       _fixed_sum, rowwise_transform)
from repro_torch.sparse import knn_cross
from repro_torch.sparse.graph import CROSS_APPROX_N

KINDS = ("ee", "ssne", "tsne", "tee", "epan")
LAMS = {"ee": 1.0, "ssne": 1.0, "tsne": 1.0, "tee": 2.0, "epan": 2.0}


def _t(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def _normal(n, d=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _jax_anchor_source(n_train, m):
    """JAX's sampled-anchor draw of (seed, it), for the port's
    `anchor_source`."""
    def source(seed, it):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        return np.array(jax.random.choice(key, n_train, shape=(m,),
                                          replace=False))
    return source


def _jax_projections(seed, n_projections, dim):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_projections)
    return _t(jnp.stack([jax.random.normal(k, (dim,)) for k in keys]))


def _port_estimator(jemb, Y_train) -> Embedding:
    """The port's estimator over a JAX fit: its spec, embedding and Y."""
    emb = Embedding(convert.spec_from_jax_fields(
        dataclasses.asdict(jemb.spec)), device="cpu")
    emb.embedding_ = _t(jemb.embedding_)
    emb._Y_train = np.asarray(Y_train)
    emb.backend_ = jemb.backend_
    return emb


@pytest.fixture(scope="module")
def mnist():
    Y, labels = mnist_like(n=160)
    return np.asarray(Y, dtype=np.float32), np.asarray(labels)


@pytest.fixture(scope="module")
def fits(mnist):
    """JAX dense fits on the first 128 rows: EE at lambda = 1 (50
    iterations) and t-SNE at lambda = 1 (30), and their port estimators."""
    Y, _ = mnist
    out = {}
    for kind, iters in (("ee", 50), ("tsne", 30)):
        jemb = JEmbedding(JEmbedSpec(
            kind=kind, lam=1.0, strategy="sd", backend="dense",
            perplexity=8.0, max_iters=iters, tol=0.0)).fit(
                jnp.asarray(Y[:128]))
        out[kind] = (jemb, _port_estimator(jemb, Y[:128]))
    return out


# -- cross-set kNN --------------------------------------------------------------


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_knn_cross_matches_jax(method):
    """Sorted distances at rtol 1e-5 and the same neighbour sets wherever
    the gap to the next neighbour exceeds that tolerance; the approximate
    search gets JAX's projection directions.  Blocks of 4 rows with a ragged
    last block."""
    Yr, Yq = _normal(60), _normal(13, seed=7)
    k = 5
    kw, pkw = dict(block_rows=4, method=method), dict(block_rows=4,
                                                       method=method)
    if method == "approx":
        kw.update(n_projections=6, window=8, seed=3)
        pkw.update(n_projections=6, window=8,
                   projections=_jax_projections(3, 6, Yr.shape[1]))
    jd2, jidx = (np.asarray(a) for a in jknn_cross(
        jnp.asarray(Yq), jnp.asarray(Yr), k + 1, **kw))
    d2, idx = knn_cross(_t(Yq), _t(Yr), k + 1, **pkw)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (13, k + 1)
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-5, atol=1e-6)
    clear = jd2[:, k] - jd2[:, k - 1] > 1e-5 * jd2[:, k]
    assert clear.mean() > 0.9
    for i in np.flatnonzero(clear):
        assert set(idx[i, :k].tolist()) == set(jidx[i, :k].tolist()), i


def test_knn_cross_approx_duplicates_match_jax():
    """With k above a row's distinct candidates the repeated candidates
    score +inf: the same slots as JAX's, over the same candidate sets."""
    Yr, Yq = _normal(12), _normal(5, seed=2)
    kw = dict(method="approx", n_projections=2, window=3)
    jd2, jidx = (np.asarray(a) for a in jknn_cross(
        jnp.asarray(Yq), jnp.asarray(Yr), 12, seed=4, **kw))
    d2, idx = knn_cross(_t(Yq), _t(Yr), 12,
                        projections=_jax_projections(4, 2, 6), **kw)
    d2, idx = d2.numpy(), idx.numpy()
    inf = ~np.isfinite(jd2)
    assert inf.any() and (~inf).any()
    np.testing.assert_array_equal(~np.isfinite(d2), inf)
    np.testing.assert_allclose(d2[~inf], jd2[~inf], rtol=1e-5, atol=1e-6)
    for i in range(Yq.shape[0]):
        assert set(idx[i][~inf[i]]) == set(jidx[i][~inf[i]]), i


@pytest.mark.parametrize("k,kw,match", [
    (0, {}, "k >= 1"),
    (11, {}, "n_train=10"),
    (11, {"method": "approx"}, "n_train=10"),
    (9, {"method": "approx", "n_projections": 1, "window": 2},
     "candidate budget"),
])
def test_knn_cross_validates_k_up_front(k, kw, match):
    with pytest.raises(ValueError, match=match):
        knn_cross(_t(_normal(3, seed=1)), _t(_normal(10)), k, **kw)


def test_knn_cross_auto_switches_at_the_reference_threshold():
    assert CROSS_APPROX_N == 20_000
    d2, idx = knn_cross(_t(_normal(4, seed=1)), _t(_normal(30)), 3,
                        method="auto")
    want = knn_cross(_t(_normal(4, seed=1)), _t(_normal(30)), 3,
                     method="exact")
    assert torch.equal(idx, want[1]) and torch.equal(d2, want[0])


@pytest.mark.parametrize("method", ["exact", "approx"])
def test_anchor_affinities_match_jax(mnist, method):
    """The same neighbours and the calibrated weights at the tolerance of
    test_calibrated_weights_match_jax; the port's blocks of ROW_BLOCK rows
    (100 queries: two blocks, the second padded)."""
    Y, _ = mnist
    Yq = Y[:100] + 0.05 * _normal(100, Y.shape[1], seed=3)
    kw = dict(n_projections=8, window=16, knn_seed=5)
    ji, jw = janchor_affinities(jnp.asarray(Yq), jnp.asarray(Y[100:]), 24,
                                8.0, method=method, **kw)
    pkw = dict(kw)
    if method == "approx":
        pkw["projections"] = _jax_projections(5, 8, Y.shape[1])
    idx, w = _anchor_affinities(_t(Yq), _t(Y[100:]), 24, 8.0, method=method,
                                **pkw)
    assert 100 > ROW_BLOCK
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-8)


def test_fixed_sum_order_is_the_length_s_alone():
    """`_fixed_sum` is a sum (to float64 rounding) whose bits for a slice do
    not depend on the other slices or on how many there are."""
    x = torch.tensor(_normal(37, 90, seed=4))
    got = _fixed_sum(x, -1)
    np.testing.assert_allclose(got.numpy(), x.double().sum(-1).numpy(),
                               rtol=1e-5)
    for i in (0, 17, 36):
        assert torch.equal(_fixed_sum(x[i:i + 1], -1), got[i:i + 1])
    assert torch.equal(_fixed_sum(x.T, 0), got)


# -- the objective and the solvers ----------------------------------------------


@pytest.mark.parametrize("sampled", [False, True], ids=["exhaustive",
                                                        "sampled"])
@pytest.mark.parametrize("kind", KINDS)
def test_transform_objective_matches_jax(kind, sampled):
    """energy_and_grad and energy at the same X and the same anchor draw
    (JAX's, through anchor_source) at 1e-5 relative."""
    rng = np.random.default_rng(11)
    n_train, n_new, k, m = 90, 17, 12, 20
    A = rng.normal(size=(n_train, 2)).astype(np.float32)
    idx = rng.integers(0, n_train, size=(n_new, k)).astype(np.int32)
    w = rng.uniform(0.01, 1.0, size=(n_new, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    X = (0.7 * rng.normal(size=(n_new, 2))).astype(np.float32)
    m_arg = m if sampled else None
    jobj = JTransformObjective(kind, LAMS[kind], jnp.asarray(A),
                               jnp.asarray(idx), jnp.asarray(w), m_arg)
    obj = TransformObjective(kind, LAMS[kind], _t(A), _t(idx), _t(w), m_arg,
                             anchor_source=_jax_anchor_source(n_train, m))
    assert obj.stochastic is sampled is jobj.stochastic
    key, jkey = ((7, 3), jax.random.fold_in(jax.random.PRNGKey(7), 3)) \
        if sampled else (None, None)
    JE, JG = jobj.energy_and_grad(jnp.asarray(X), jkey)
    E, G = obj.energy_and_grad(_t(X), key)
    JG = np.asarray(JG)
    np.testing.assert_allclose(float(E), float(JE), rtol=1e-5)
    np.testing.assert_allclose(G.numpy(), JG, rtol=1e-5,
                               atol=1e-5 * np.abs(JG).max())
    np.testing.assert_allclose(float(obj.energy(_t(X), key)), float(JE),
                               rtol=1e-5)
    jsolve, _ = jobj.make_direction_solver()
    solve, _ = obj.make_direction_solver()
    P, _ = solve((), _t(X), G)
    JP, _ = jsolve((), jnp.asarray(X), JG)
    np.testing.assert_allclose(P.numpy(), np.asarray(JP), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(JP)).max())


def _jax_problem(fits, mnist, kind):
    """JAX's neighbours, weights and barycentre start for the 32 held-out
    rows against a fit's embedding."""
    Y, _ = mnist
    jemb, _ = fits[kind]
    A = jemb.embedding_
    ji, jw = janchor_affinities(jnp.asarray(Y[128:]), jnp.asarray(Y[:128]),
                                24, 8.0)
    X0 = jnp.einsum("mk,mkd->md", jw, A[ji])
    return A, ji, jw, X0


@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("sampled", [False, True], ids=["exhaustive",
                                                        "sampled"])
@pytest.mark.parametrize("kind", ["ee", "tsne"])
def test_rowwise_solver_matches_jax(fits, mnist, kind, sampled, tol):
    """X at atol 1e-5 and the same outer iterations and frozen rows, from
    JAX's neighbours, weights and start (and draws).  At tol = 1e-3 rows
    freeze by the per-row test before the budget."""
    jemb, _ = fits[kind]
    A, ji, jw, X0 = _jax_problem(fits, mnist, kind)
    m = 50 if sampled else None
    kw = dict(n_negatives=m, max_iters=12, tol=tol, seed=2,
              ls=jemb.spec.resolved_ls())
    want = jrowwise(kind, 1.0, A, ji, jw, X0, **kw)
    kw["ls"] = EmbedSpec(kind=kind).resolved_ls()
    got = rowwise_transform(kind, 1.0, _t(A), _t(ji), _t(jw), _t(X0),
                            anchor_source=_jax_anchor_source(128, 50), **kw)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), atol=1e-5)
    assert (got.n_iters, got.n_converged, got.n_rows) == (
        want.n_iters, want.n_converged, want.n_rows)
    if tol:
        assert got.n_converged > 0
    # about one device read an outer iteration (and one for the result)
    assert got.n_reads <= 3 * got.n_iters + 2


@pytest.mark.parametrize("knn_method", ["exact", "approx"])
@pytest.mark.parametrize("sampled", [False, True], ids=["exhaustive",
                                                        "sampled"])
@pytest.mark.parametrize("kind", ["ee", "tsne"])
def test_engine_transform_matches_jax(fits, mnist, kind, sampled,
                                      knn_method):
    """The default (engine) solver through the whole pipeline: the energy
    trace at rtol 1e-4, the port's own cross-kNN and calibration, JAX's
    draws (anchors and, for the approximate search, projections)."""
    Y, _ = mnist
    jemb, emb = fits[kind]
    tspec = dict(max_iters=12, exhaustive=not sampled, seed=1,
                 knn_method=knn_method, n_projections=8, window=16)
    jX = jemb.transform(jnp.asarray(Y[128:]), spec=JTransformSpec(**tspec))
    X = emb.transform(Y[128:], TransformSpec(**tspec),
                      anchor_source=_jax_anchor_source(128, 50),
                      projections=_jax_projections(1, 8, Y.shape[1]))
    jres, res = jemb.last_transform_result_, emb.last_transform_result_
    assert X.shape == jX.shape == (32, 2)
    assert res.n_iters == jres.n_iters == 12
    np.testing.assert_allclose(res.energies, np.asarray(jres.energies),
                               rtol=1e-4)


def test_rowwise_solver_is_batch_composition_invariant():
    """The serving guarantee, on the reference's own problem: a row's
    transform is the same alone, inside a batch and in chunks of 5."""
    Y, _ = mnist_like(n=160)
    emb = Embedding(EmbedSpec(kind="ee", lam=10.0, strategy="sd",
                              backend="dense", perplexity=8.0, max_iters=10,
                              tol=0.0), device="cpu").fit(Y[:128])
    Q = Y[128:]
    for exhaustive in (False, True):
        tspec = TransformSpec(solver="rowwise", max_iters=12,
                              exhaustive=exhaustive)
        joint = emb.transform(Q, tspec).numpy()
        single = np.stack([emb.transform(Q[i:i + 1], tspec).numpy()[0]
                           for i in range(Q.shape[0])])
        np.testing.assert_allclose(single, joint, atol=1e-5)
        chunked = emb.transform(Q, tspec.replace(batch_size=5)).numpy()
        np.testing.assert_allclose(chunked, joint, atol=1e-5)
        res = emb.last_transform_result_
        assert res.n_rows == 32 and res.n_iters == 12


# -- TransformSpec ---------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    ({"knn_method": "annoy"}, "knn_method"),
    ({"knn_method": "annoy"}, "exact"),
    ({"solver": "newton"}, "solver"),
    ({"max_iters": -1}, "max_iters"),
    ({"batch_size": 1.5}, "batch_size"),
    ({"knn_method": "approx", "n_projections": 0}, "n_projections"),
    ({"tol": -0.5}, "tol"),
])
def test_transform_spec_validation_matches_jax(kw, match):
    """The port refuses what the reference refuses, naming the options."""
    with pytest.raises(ValueError, match=match):
        JTransformSpec(**kw)
    with pytest.raises(ValueError, match=match):
        TransformSpec(**kw)


def test_transform_spec_fields_frozen_and_deferred():
    assert ([f.name for f in dataclasses.fields(TransformSpec)]
            == [f.name for f in dataclasses.fields(JTransformSpec)])
    assert dataclasses.asdict(TransformSpec()) == dataclasses.asdict(
        JTransformSpec())
    t = TransformSpec(max_iters=7)
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.max_iters = 9
    assert t.replace(solver="rowwise").solver == "rowwise"
    assert t.max_iters == 7
    spec = EmbedSpec(transform_iters=33, transform_negatives=11, tol=2e-4)
    r = resolve_transform_spec(spec, TransformSpec())
    assert (r.max_iters, r.n_negatives, r.tol) == (33, 11, 2e-4)
    r2 = resolve_transform_spec(spec, TransformSpec(max_iters=5, tol=0.0))
    assert (r2.max_iters, r2.tol) == (5, 0.0)
    d = EmbedSpec()
    assert (d.transform_iters, d.transform_negatives) == (100, 50)


# -- Embedding.transform ----------------------------------------------------------


@pytest.fixture(scope="module")
def port_fit(mnist):
    Y, _ = mnist
    emb = Embedding(EmbedSpec(kind="ee", lam=10.0, strategy="sd",
                              backend="dense", perplexity=8.0, max_iters=15,
                              tol=0.0), device="cpu").fit(Y[:128])
    return Y, emb


def test_transform_leaves_training_embedding_bit_identical(port_fit):
    Y, emb = port_fit
    before = emb.embedding_.clone()
    X_new = emb.transform(torch.tensor(Y[128:]), TransformSpec(max_iters=15))
    assert tuple(X_new.shape) == (32, 2)
    assert bool(torch.isfinite(X_new).all())
    assert torch.equal(before, emb.embedding_)
    assert emb.result_.n_iters == 15          # no re-fit


def test_transform_exhaustive_is_deterministic(port_fit):
    Y, emb = port_fit
    tspec = TransformSpec(max_iters=10, exhaustive=True)
    a = emb.transform(Y[128:], tspec)
    b = emb.transform(Y[128:], tspec)
    assert torch.equal(a, b)
    assert emb.last_transform_result_.energies.shape == (11,)


def test_transform_empty_batch_and_unfitted(port_fit):
    Y, emb = port_fit
    assert tuple(emb.transform(np.zeros((0, Y.shape[1]))).shape) == (0, 2)
    with pytest.raises(ValueError, match="fitted"):
        Embedding(EmbedSpec(), device="cpu").transform(Y[:2])
    no_y = Embedding(EmbedSpec(kind="ee", lam=10.0, backend="dense",
                               max_iters=2), device="cpu").fit(
        None, X0=emb.X0_, aff=emb.affinities_)
    with pytest.raises(ValueError, match="precomputed affinities"):
        no_y.transform(Y[:2])


def test_transform_refuses_the_legacy_keywords(port_fit):
    Y, emb = port_fit
    with pytest.raises(TypeError):
        emb.transform(Y[128:], max_iters=6)


def test_transform_places_heldout_mnist_near_own_class():
    """Held-out digits land nearer their own class's training centroid
    than any other's for >= 80% of points (the reference's acceptance
    test, on the port)."""
    Y, labels = mnist_like(n=480)
    n_tr = 400
    emb = Embedding(EmbedSpec(kind="tsne", lam=1.0, strategy="sd",
                              backend="dense", perplexity=15.0, max_iters=60,
                              tol=0.0), device="cpu").fit(Y[:n_tr])
    X = emb.embedding_.numpy()
    X_new = emb.transform(Y[n_tr:], TransformSpec(max_iters=40)).numpy()
    cents = np.stack([X[labels[:n_tr] == c].mean(0) for c in range(10)])
    d = ((X_new[:, None, :] - cents[None]) ** 2).sum(-1)
    assert float((d.argmin(1) == labels[n_tr:]).mean()) >= 0.8
