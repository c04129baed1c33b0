"""The port's versioned artifacts (repro_torch.api.artifact, schema v1)
against the JAX reference's (repro.api.artifact): the committed golden file
loads and serves in the port, artifacts cross between the two packages in
both directions, and the port keeps the reference's compatibility rules
(tests/test_api.py:461-590): a bit-identical exhaustive transform after a
round trip, `train="ref"` storage with its hash check, newer schemas
refused, unknown keys ignored, pickling and unfitted saves refused.
"""
import dataclasses
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.api import TransformSpec as JTransformSpec
from repro.api.artifact import load_artifact as jload_artifact
from repro.data import mnist_like
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec, TransformSpec, read_header
from repro_torch.api.artifact import write_artifact

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_artifact_v1.npz")


@pytest.fixture(scope="module")
def fitted_small():
    Y, _ = mnist_like(n=140)
    emb = Embedding(EmbedSpec(kind="ee", lam=10.0, strategy="sd",
                              backend="dense", perplexity=8.0, max_iters=12,
                              tol=0.0, seed=0), device="cpu")
    emb.fit(Y[:120])
    return np.asarray(Y), emb


def _rewrite(path, mutate):
    hdr = read_header(path)
    with np.load(path) as z:
        arrays = {k: np.array(z[k]) for k in z.files if k != "__header__"}
    mutate(hdr, arrays)
    write_artifact(path, hdr, arrays)


def test_golden_artifact_loads_and_serves_in_the_port():
    hdr = read_header(GOLDEN)
    assert hdr["schema_version"] == 1
    est = Embedding.load(GOLDEN, device="cpu")
    assert tuple(est.embedding_.shape) == (32, 2)
    assert est.embedding_.dtype == torch.float32
    assert np.asarray(est._Y_train).shape == (32, 6)
    assert (est.spec.kind, est.spec.perplexity, est.spec.n_neighbors) == (
        "ee", 4.0, 12)
    assert est.spec.kernel_impl == "auto" and est.backend_ == "dense"
    tspec = TransformSpec(max_iters=2, exhaustive=True, solver="rowwise")
    out = est.transform(np.asarray(est._Y_train[:3]), tspec)
    assert bool(torch.isfinite(out).all())
    # and it serves what the reference serves from it
    jest = jload_artifact(GOLDEN)
    want = jest.transform(np.asarray(jest._Y_train[:3]),
                          spec=JTransformSpec(max_iters=2, exhaustive=True,
                                              solver="rowwise"))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_roundtrip_transform_bit_identical(tmp_path, fitted_small):
    Y, emb = fitted_small
    path = str(tmp_path / "model.npz")
    assert emb.save(path) == path
    loaded = Embedding.load(path, device="cpu")
    assert torch.equal(loaded.embedding_, emb.embedding_)
    assert loaded.spec == emb.spec
    for solver in ("engine", "rowwise"):
        tspec = TransformSpec(max_iters=8, exhaustive=True, solver=solver)
        assert torch.equal(emb.transform(Y[120:], tspec),
                           loaded.transform(Y[120:], tspec))
    hdr = read_header(path)
    assert hdr["schema_version"] == 1 and hdr["graph"]["k"] == 24
    assert hdr["train"]["storage"] == "snapshot"
    assert hdr["train"]["dtype"] == "float32"
    assert hdr["stats"]["backend"] == "dense"
    assert hdr["stats"]["n_iters"] == 12
    assert hdr["spec"]["transform_iters"] == 100


def test_port_artifact_loads_in_jax(tmp_path, fitted_small):
    """A port-written file loads in `repro.api.artifact.load_artifact`: the
    same spec (kernel_impl in the reference's words), embedding and Y."""
    Y, emb = fitted_small
    path = str(tmp_path / "port.npz")
    emb.spec = emb.spec.replace(kernel_impl="torch")
    try:
        emb.save(path)
    finally:
        emb.spec = emb.spec.replace(kernel_impl="auto")
    jest = jload_artifact(path)
    assert jest.spec.kernel_impl == "jnp"
    assert convert.spec_from_jax_fields(dataclasses.asdict(jest.spec)) == (
        emb.spec.replace(kernel_impl="torch"))
    assert (jest.spec.kind, jest.spec.lam, jest.spec.max_iters) == (
        "ee", 10.0, 12)
    np.testing.assert_array_equal(np.asarray(jest.embedding_),
                                  emb.embedding_.numpy())
    np.testing.assert_array_equal(np.asarray(jest._Y_train), Y[:120])
    out = jest.transform(jnp.asarray(Y[120:]),
                         spec=JTransformSpec(max_iters=3, exhaustive=True))
    assert np.all(np.isfinite(np.asarray(out)))


@pytest.mark.parametrize("sampled", [False, True], ids=["exhaustive",
                                                        "sampled"])
def test_jax_artifact_loads_in_the_port(tmp_path, sampled):
    """A file fitted and saved by `repro` loads in the port, and its rowwise
    transform matches JAX's at atol 1e-5 (t-SNE; the sampled mode with
    JAX's anchor draws)."""
    import jax

    Y, _ = mnist_like(n=150)
    Y = np.asarray(Y, dtype=np.float32)
    jemb = JEmbedding(JEmbedSpec(kind="tsne", lam=1.0, strategy="sd",
                                 backend="dense", perplexity=8.0,
                                 max_iters=30, tol=0.0,
                                 kernel_impl="pallas-interpret"))
    jemb.fit(jnp.asarray(Y[:120]))
    path = str(tmp_path / "jax.npz")
    jemb.save(path)
    est = Embedding.load(path, device="cpu")
    assert est.spec.kernel_impl == "torch"
    assert est.spec == convert.spec_from_jax_fields(
        dataclasses.asdict(jemb.spec))
    assert repr(est).startswith("Embedding(kind='tsne'")
    assert f"loaded[v1:{path}]" in repr(est)

    def source(seed, it):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        return np.array(jax.random.choice(key, 120, shape=(50,),
                                          replace=False))

    tspec = dict(solver="rowwise", max_iters=10, exhaustive=not sampled)
    want = jemb.transform(jnp.asarray(Y[120:]), spec=JTransformSpec(**tspec))
    got = est.transform(Y[120:], TransformSpec(**tspec),
                        anchor_source=source)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_loader_maps_kernel_impl_and_drops_checkpoint_dir(tmp_path,
                                                          fitted_small):
    _, emb = fitted_small
    path = str(tmp_path / "ckpt.npz")
    emb.save(path)

    def mutate(hdr, arrays):
        hdr["spec"].update(kernel_impl="pallas", checkpoint_dir="/ckpt",
                           checkpoint_every=7)

    _rewrite(path, mutate)
    est = Embedding.load(path, device="cpu")
    assert est.spec.kernel_impl == "kernel"
    # checkpointing is ported: both fields are kept, as the reference's
    # loader keeps them (they were dropped before)
    assert est.spec.checkpoint_dir == "/ckpt"
    assert est.spec.checkpoint_every == 7
    est.save(path)
    assert read_header(path)["spec"]["checkpoint_dir"] == "/ckpt"
    assert read_header(path)["spec"]["checkpoint_every"] == 7
    assert read_header(path)["spec"]["kernel_impl"] == "pallas"


def test_ref_mode_and_hash_verification(tmp_path, fitted_small):
    Y, emb = fitted_small
    yref = str(tmp_path / "Y.npy")
    np.save(yref, np.asarray(emb._Y_train))
    path = str(tmp_path / "ref.npz")
    emb.save(path, train="ref", train_ref=yref)
    with np.load(path) as z:
        assert "Y" not in z
    loaded = Embedding.load(path, device="cpu")
    np.testing.assert_array_equal(loaded._Y_train, emb._Y_train)
    bad = np.array(np.load(yref))
    bad[0, 0] += 1.0
    np.save(yref, bad)
    with pytest.raises(ValueError, match="hash mismatch"):
        Embedding.load(path, device="cpu")
    ok = Embedding.load(path, Y_train=torch.tensor(emb._Y_train),
                        device="cpu")
    assert ok._Y_train is not None
    # an unreadable reference loads, and transform says what is missing
    os.remove(yref)
    orphan = Embedding.load(path, device="cpu")
    with pytest.raises(ValueError, match="Y_train="):
        orphan.transform(Y[120:])
    with pytest.raises(ValueError, match="train_ref"):
        emb.save(path, train="ref")
    with pytest.raises(ValueError, match="storage"):
        emb.save(path, train="cloud")


def test_refuses_newer_schema(tmp_path, fitted_small):
    _, emb = fitted_small
    path = str(tmp_path / "future.npz")
    emb.save(path)

    def mutate(hdr, arrays):
        hdr["schema_version"] = 99
        hdr["from_the_future"] = True

    _rewrite(path, mutate)
    with pytest.raises(ValueError, match="newer than this"):
        Embedding.load(path, device="cpu")


def test_ignores_unknown_header_keys_and_members(tmp_path, fitted_small):
    _, emb = fitted_small
    path = str(tmp_path / "forward.npz")
    emb.save(path)

    def mutate(hdr, arrays):
        hdr["new_toplevel_section"] = {"a": 1}
        hdr["spec"]["future_knob"] = "x"
        hdr["spec"]["ls"] = {"c1": 1e-4, "future_ls_knob": 1}
        arrays["future_array"] = np.zeros(3)

    _rewrite(path, mutate)
    loaded = Embedding.load(path, device="cpu")
    assert torch.equal(loaded.embedding_, emb.embedding_)
    assert loaded.spec.ls.c1 == 1e-4


def test_not_an_artifact(tmp_path):
    path = str(tmp_path / "plain.npz")
    np.savez(path, X=np.zeros(3))
    with pytest.raises(ValueError, match="not a repro embedding artifact"):
        read_header(path)


def test_pickling_refused_and_unfitted_save_refused(tmp_path, fitted_small):
    _, emb = fitted_small
    with pytest.raises(TypeError, match="save"):
        pickle.dumps(emb)
    with pytest.raises(ValueError, match="fitted"):
        Embedding(EmbedSpec(), device="cpu").save(str(tmp_path / "no.npz"))
    aff_only = Embedding(EmbedSpec(kind="ee", lam=10.0, backend="dense",
                                   max_iters=2), device="cpu").fit(
        None, X0=emb.X0_, aff=emb.affinities_)
    with pytest.raises(ValueError, match="affinities"):
        aff_only.save(str(tmp_path / "no.npz"))


def test_repr_shows_lifecycle(tmp_path, fitted_small):
    _, emb = fitted_small
    assert "unfitted" in repr(Embedding(EmbedSpec(), device="cpu"))
    assert "fitted[dense]" in repr(emb) and "n_train=120" in repr(emb)
    path = str(tmp_path / "r.npz")
    emb.save(path)
    r = repr(Embedding.load(path, device="cpu"))
    assert "loaded[v1:" in r and path in r


def test_load_runs_on_cuda_unless_told_otherwise(monkeypatch):
    """`load` with no device means CUDA: without it, it raises rather than
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Embedding.load(GOLDEN)
