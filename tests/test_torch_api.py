"""The port's estimator (repro_torch.api) against the JAX reference.

`Embedding(EmbedSpec(...), device="cpu").fit(Y)` runs the whole dense fit
— affinities, spectral start, strategy, fused steps — and must give JAX's
energy trace at rtol 1e-4 (the reference's own trace tolerance,
tests/test_api.py:92).  The energy depends only on pairwise distances, so
the sign of a spectral-start eigenvector does not change the trace.

GD and FP are pinned at lambda = 1.  At larger lambda their first steps
from the 0.1-scaled spectral start are huge, and a last-bit difference —
in the start, or in the order of a sum — grows to ~1e-3 within five
iterations: on such problems the reference's own jnp and Pallas-interpret
paths differ by up to 8.6e-4 from one start.  SD and SD- do not amplify
it, and run at each kind's lambda.

DiagH, L-BFGS and nonlinear CG are pinned at lambda = 1 on EE and t-SNE
for the same reason.  DiagH divides by the Hessian's diagonal, whose
smallest entries are differences of larger terms: their rounding (the
reference's float32 s-SNE diagonal is 8e-6 of max|d| from float64, the
port's 6e-7) becomes a relative error of the step, and on s-SNE, EE at
lambda = 50 and t-EE at lambda = 10 the traces part by 2e-4 to 5e-4, as
the reference's own two paths do on EE (2.0e-4) and Epanechnikov EE
(9.4e-3 at lambda = 1, where a pair crossing the support edge t = 1 flips
the diagonal).  Nonlinear CG's PR+ steps and L-BFGS's curvature pairs
carry GD's amplification at lambda = 50 (the reference's two paths part
by up to 4.7e-4 on t-EE at lambda = 10).  Each alias of a strategy runs
in place of its name once.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.core import laplacian_eigenmaps as jeig
from repro.core import make_affinities as jmake
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec, resolve_backend
from repro_torch.api.registries import AUTO_SPARSE_N
from repro_torch.kernels import ops
from tests.conftest import three_loops

LAMS = {"ee": 50.0, "ssne": 1.0, "tsne": 1.0, "tee": 10.0, "epan": 10.0}


@pytest.fixture(scope="module")
def Y():
    return np.array(three_loops(n_per=16, loops=3, dim=8), dtype=np.float32)


def _traces(Y, **kw):
    jres = JEmbedding(JEmbedSpec(**kw)).fit(jnp.asarray(Y)).result_
    tres = Embedding(EmbedSpec(**kw), device="cpu").fit(Y).result_
    return jres, tres


@pytest.mark.parametrize("kind,strategy,lam", [
    *[(k, "sd", LAMS[k]) for k in LAMS],
    ("ee", "gd", 1.0),
    ("ee", "fp", 1.0),
    *[(k, "sd-", LAMS[k]) for k in ("ee", "ssne", "tee", "epan")],
    ("tsne", "sdminus", 1.0),
    ("ee", "diag", 1.0),
    ("tsne", "diagh", 1.0),
    ("ee", "lbfgs", 1.0),
    ("tsne", "l-bfgs", 1.0),
    ("ee", "cg", 1.0),
    ("tsne", "nonlinearcg", 1.0),
])
def test_fit_energy_trace_matches_jax(Y, kind, strategy, lam):
    jres, tres = _traces(Y, kind=kind, strategy=strategy, backend="dense",
                         lam=lam, perplexity=8.0, max_iters=5, tol=0.0)
    assert tres.n_iters == jres.n_iters == 5
    np.testing.assert_allclose(tres.energies, jres.energies, rtol=1e-4)
    np.testing.assert_array_equal(tres.n_fevals, jres.n_fevals)
    assert tres.energies[-1] < tres.energies[0]
    assert ops.last_dispatch("pairwise_terms")["path"] == "torch"


@pytest.mark.parametrize("strategy,lam", [("sd", 50.0), ("gd", 1.0),
                                          ("fp", 1.0)])
def test_fit_from_carried_jax_state(Y, strategy, lam):
    """JAX's affinities, start and spec carried across by convert.py give
    the same trace (SD sparsified to kappa = 7)."""
    jspec = JEmbedSpec(kind="ee", strategy=strategy, backend="dense",
                       lam=lam, perplexity=8.0, max_iters=5, tol=0.0,
                       strategy_opts={"kappa": 7} if strategy == "sd" else {},
                       kernel_impl="jnp")
    aff = jmake(jnp.asarray(Y), 8.0, model="ee")
    X0 = jeig(aff.Wp, 2) * 0.1
    jres = JEmbedding(jspec).fit(None, X0=X0, aff=aff).result_
    spec = convert.spec_from_jax_fields(dataclasses.asdict(jspec))
    assert spec.kernel_impl == "torch" and spec.strategy == strategy
    emb = Embedding(spec, device="cpu").fit(
        None, X0=convert.embedding_from_numpy(X0, "cpu"),
        aff=convert.affinities_from_numpy(aff.Wp, aff.Wm, "cpu"))
    np.testing.assert_allclose(emb.result_.energies, jres.energies,
                               rtol=1e-4)
    assert emb.backend_ == "dense"
    assert emb.embedding_.shape == (Y.shape[0], 2)


@pytest.mark.parametrize("strategy,opts", [
    ("diag", {"floor_scale": 1e-6}), ("sd-", {"cg_maxiter": 10}),
    ("lbfgs", {"m": 20}), ("cg", {})])
def test_fit_lineup_from_carried_jax_state(Y, strategy, opts):
    """The rest of the lineup carried across by convert.py with its
    strategy_opts: the same trace as JAX's from JAX's affinities and start
    (EE at lambda = 1, where no method amplifies a last-bit difference)."""
    jspec = JEmbedSpec(kind="ee", strategy=strategy, backend="dense",
                       lam=1.0, perplexity=8.0, max_iters=5, tol=0.0,
                       strategy_opts=opts, kernel_impl="jnp")
    aff = jmake(jnp.asarray(Y), 8.0, model="ee")
    X0 = jeig(aff.Wp, 2) * 0.1
    jres = JEmbedding(jspec).fit(None, X0=X0, aff=aff).result_
    spec = convert.spec_from_jax_fields(dataclasses.asdict(jspec))
    assert spec.strategy == strategy and dict(spec.strategy_opts) == opts
    emb = Embedding(spec, device="cpu").fit(
        None, X0=convert.embedding_from_numpy(X0, "cpu"),
        aff=convert.affinities_from_numpy(aff.Wp, aff.Wm, "cpu"))
    np.testing.assert_allclose(emb.result_.energies, jres.energies,
                               rtol=1e-4)
    np.testing.assert_array_equal(emb.result_.n_fevals, jres.n_fevals)


def test_registry_matches_jax_lineup():
    """Every strategy the reference registers is registered here, with its
    aliases, its initial-step policy and its backends; the dense-only ones
    resolve to dense under auto above the sparse cut-off, as in the
    reference."""
    from repro.api import registries as jreg
    from repro_torch.api import registries as preg
    assert preg.available_strategies() == jreg.available_strategies()
    assert preg._STRATEGY_ALIASES == jreg._STRATEGY_ALIASES
    for name, jentry in jreg.STRATEGIES.items():
        entry = preg.strategy_entry(name)
        assert entry.default_ls_init == jentry.default_ls_init
        assert entry.backends == jentry.backends
        for n_devices in (1, 2):
            want = jreg.resolve_backend("auto", n=AUTO_SPARSE_N + 1,
                                        n_devices=n_devices, strategy=name)
            assert resolve_backend("auto", n=AUTO_SPARSE_N + 1,
                                   n_devices=n_devices,
                                   strategy=name) == want
    for alias, name in jreg._STRATEGY_ALIASES.items():
        assert EmbedSpec(strategy=alias.upper()).strategy == name


def test_spec_from_jax_fields_maps_and_validates():
    fields = dataclasses.asdict(JEmbedSpec(kind="tsne", lam=1.0,
                                           kernel_impl="pallas",
                                           n_neighbors=30))
    spec = convert.spec_from_jax_fields(fields)
    assert (spec.kind, spec.lam, spec.kernel_impl) == ("tsne", 1.0, "kernel")
    assert (spec.n_neighbors, spec.n_negatives, spec.seed) == (30, 5, 0)
    with pytest.raises(ValueError, match="counterpart"):
        convert.spec_from_jax_fields({**fields, "mesh_shape": (2, 2)})


def test_embedding_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Embedding(EmbedSpec())
    assert Embedding(EmbedSpec(), device="cpu").device.type == "cpu"


def test_auto_backend_above_cutoff_raises():
    """Above AUTO_SPARSE_N, backend="auto" resolves to the sparse backend
    (it raised until the sparse backend was ported); what still raises there
    is what the sparse backend refuses, as in the reference: a neighbour
    list narrower than the perplexity."""
    assert resolve_backend("auto", n=AUTO_SPARSE_N, strategy="sd") == "dense"
    for strategy in ("sd", "fp", "gd"):
        assert resolve_backend("auto", n=AUTO_SPARSE_N + 1,
                               strategy=strategy) == "sparse"
    assert resolve_backend("dense", n=10 * AUTO_SPARSE_N,
                           strategy="sd") == "dense"
    with pytest.raises(ValueError, match="n_neighbors"):
        Embedding(EmbedSpec(perplexity=20.0, n_neighbors=10),
                  device="cpu").fit(
            np.zeros((AUTO_SPARSE_N + 1, 3), np.float32))


def test_auto_backend_above_cutoff_fits_sparse_and_descends():
    """The acceptance fit of the sparse slice on the CPU: N > 2048 with the
    default backend="auto" runs the sparse backend (ELL graph, power-
    iteration spectral start, sampled negatives, PCG) and descends."""
    from repro_torch.data import mnist_like
    from repro_torch.sparse import SparseAffinities

    Y, _ = mnist_like(n=AUTO_SPARSE_N + 52, dim=30, seed=1)
    seen = []
    emb = Embedding(EmbedSpec(kind="tsne", lam=1.0, perplexity=8.0,
                              n_neighbors=24, n_negatives=8, max_iters=8),
                    device="cpu").fit(Y, callback=lambda it, X, e, d:
                                      seen.append(d))
    e = emb.result_.energies
    assert emb.backend_ == "sparse" and "fitted[sparse]" in repr(emb)
    assert isinstance(emb.affinities_, SparseAffinities)
    assert emb.affinities_.graph.k == 24
    assert np.all(np.isfinite(e)) and e[-1] < e[0]
    assert emb.embedding_.shape == (Y.shape[0], 2)
    assert set(emb.result_.phase_times) == {
        "knn_s", "calibrate_s", "reverse_s", "spectral_init_s"}
    assert all(d["pcg_iters"] >= 1 and d["z_ema"] > 0 for d in seen)
    assert ops.last_dispatch("ell_lap_matvec")["path"] == "torch"


def test_spec_validation_and_unported_options():
    with pytest.raises(ValueError, match="model families"):
        EmbedSpec(kind="nope")
    with pytest.raises(ValueError, match="registered strategies"):
        EmbedSpec(strategy="sparsesd")    # the reference registers none
    with pytest.raises(ValueError, match="not available on backend"):
        EmbedSpec(strategy="sd-", backend="sparse")
    with pytest.raises(ValueError, match="registered backends"):
        EmbedSpec(backend="dense_mesh")           # the name is dense-mesh
    with pytest.raises(ValueError, match="kernel_impl"):
        EmbedSpec(kernel_impl="pallas")
    with pytest.raises(ValueError, match="kernel_precision"):
        EmbedSpec(kernel_precision="float16")
    assert EmbedSpec(strategy="SD").strategy == "sd"
    assert EmbedSpec().kernel_args() == {}
    # checkpointing is ported: the reference's two fields are accepted
    spec = EmbedSpec(checkpoint_dir="ckpt", checkpoint_every=7)
    assert (spec.checkpoint_dir, spec.checkpoint_every) == ("ckpt", 7)
    assert EmbedSpec().checkpoint_every == JEmbedSpec().checkpoint_every


def test_callback_sees_each_iteration_and_bf16_fit(Y):
    seen = []
    spec = EmbedSpec(kind="tsne", lam=1.0, perplexity=8.0, max_iters=3,
                     tol=0.0, kernel_precision="bfloat16")
    emb = Embedding(spec, device="cpu")
    X = emb.fit_transform(Y, callback=lambda it, X, e, d: seen.append(d))
    assert [d["it"] for d in seen] == [1, 2, 3]
    assert [d["energy"] for d in seen] == list(emb.result_.energies[1:])
    assert X.shape == (Y.shape[0], 2) and bool(torch.isfinite(X).all())
    assert ops.last_dispatch("pairwise_terms")["storage"] == "bfloat16"
    assert emb.result_.energies[-1] < emb.result_.energies[0]
    assert set(emb.result_.phase_times) == {"affinities_s", "spectral_init_s"}
    assert "fitted[dense]" in repr(emb)
