"""The port's checkpointing (repro_torch.ckpt) and resume against the
reference.

The reference's tests/test_checkpointer.py cases on the port's
`Checkpointer`; a checkpoint directory written by either package restored
by the other, bit for bit, with the same manifest; and resumed fits on the
CPU (``device="cpu"``): interrupted, then continued through
`Embedding.resume`, each must give the uninterrupted run's energies and
embedding bit for bit after the checkpoint (the reference's
tests/test_engine.py::test_resume_replays_uninterrupted_trace) on the
dense (EE, t-SNE; SD and the strategies whose state holds python scalars),
sparse (EE, t-SNE), tree and sparse-sharded (two gloo ranks, spawned by
tests/test_torch_sharding_ranks.py) backends.  The port's resumed trace is
held against JAX's uninterrupted one at rtol 1e-4 (tests/test_api.py:92)
for dense EE at lambda = 1 and sparse t-SNE at mu_scale = 1e-3 (ROADMAP.md,
Queue 3 says why these settings); the telemetry JSONL stays contiguous
across a resume (tests/test_obs.py:249).  The same resume and telemetry on
the card's kernels: tests/test_torch_kernels_cuda.py (JAX-free).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_sharding_ranks as worker
from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.ckpt import Checkpointer as JCheckpointer
from repro.embed.trainer import _sparse_spectral_init as jspectral_init
from repro.sparse import sparse_affinities as jsparse_affinities
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec
from repro_torch.ckpt import Checkpointer
from repro_torch.ckpt import checkpointer as ckmod
from repro_torch.obs import load_jsonl
from tests.conftest import three_loops


def _tree(step):
    return {"X": torch.arange(12.0).reshape(3, 4) + step,
            "opt": {"m": torch.ones((5,)) * step}}


@pytest.fixture(scope="module")
def Y():
    return np.array(three_loops(n_per=24, loops=3, dim=8), dtype=np.float32)


# -- the Checkpointer (tests/test_checkpointer.py on the port) ------------------


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, _tree(3))
    restored = ck.restore(3, _tree(0))
    assert torch.equal(restored["X"], _tree(3)["X"])
    assert torch.equal(restored["opt"]["m"], torch.full((5,), 3.0))


def test_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]  # keep-2 GC


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))
    path = os.path.join(str(tmp_path), "step_000000000001", "arr_0.npy")
    arr = np.load(path)
    arr[0] += 1
    np.save(path, arr)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(1, _tree(0))


def test_restore_latest_empty(tmp_path):
    ck = Checkpointer(str(tmp_path))
    step, tree = ck.restore_latest(_tree(0))
    assert step is None and tree is None


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(7, _tree(7))
    ck.wait()
    assert ck.latest_step() == 7


def test_manifest_contents(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(2, _tree(2))
    with open(os.path.join(str(tmp_path), "step_000000000002",
                           "manifest.json")) as f:
        m = json.load(f)
    assert m["step"] == 2
    assert len(m["arrays"]) == 2
    assert m["arrays"][0]["shape"] == [3, 4]


def test_leaf_count_mismatch_and_bfloat16_refused(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))
    with pytest.raises(ValueError, match="arrays"):
        ck.restore(1, {"X": torch.zeros(3, 4)})
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(2, {"X": torch.zeros(2, dtype=torch.bfloat16)})
    assert ck.all_steps() == [1]


def test_nested_state_with_python_scalars_round_trips(tmp_path):
    """A strategy state like L-BFGS's: tensors, python ints and bools,
    tuples and None, in `jax.tree_util`'s order; each leaf comes back in
    its example leaf's kind."""
    state = {"S": torch.randn(2, 3, 2,
                              generator=torch.Generator().manual_seed(0)),
             "head": torch.tensor(1),
             "pushes": 3, "started": True, "pair": (torch.ones(2), None),
             "alpha": np.asarray(0.25, np.float64)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state)
    tmpl = {"S": torch.zeros(2, 3, 2), "head": torch.tensor(0),
            "pushes": 0, "started": False, "pair": (torch.zeros(2), None),
            "alpha": np.zeros(())}
    got = ck.restore(1, tmpl)
    assert torch.equal(got["S"], state["S"]) and torch.equal(
        got["head"], state["head"])
    assert got["pushes"] == 3 and type(got["pushes"]) is int
    assert got["started"] is True
    assert torch.equal(got["pair"][0], torch.ones(2)) and got["pair"][1] is None
    assert float(got["alpha"]) == 0.25


# -- across the two packages ------------------------------------------------------


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"X": rng.normal(size=(7, 2)).astype(np.float32),
            "state": {"chol": rng.normal(size=(7, 7)).astype(np.float32),
                      "B": rng.normal(size=(7, 7)).astype(np.float32)},
            "alpha": np.asarray(0.125, np.float64),
            "idx": np.arange(5, dtype=np.int32)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:012d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoint_crosses_packages_bit_for_bit(tmp_path, writer):
    """A dict pytree saved by either package restores through the other
    with equal bits; both write the same manifest for the same arrays."""
    a = _arrays()
    as_torch = {"X": torch.from_numpy(a["X"]),
                "state": {k: torch.from_numpy(v)
                          for k, v in a["state"].items()},
                "alpha": a["alpha"], "idx": torch.from_numpy(a["idx"])}
    # float64 stays numpy on JAX's side (x64 is off), as its engine keeps
    # alpha
    as_jax = {**jax.tree_util.tree_map(jnp.asarray, a), "alpha": a["alpha"]}
    jd, pd = str(tmp_path / "j"), str(tmp_path / "p")
    JCheckpointer(jd).save(4, as_jax)
    Checkpointer(pd).save(4, as_torch)
    assert _manifest(jd, 4) == _manifest(pd, 4)

    src = jd if writer == "repro" else pd
    got = Checkpointer(src).restore(4, as_torch)
    assert torch.equal(got["X"], as_torch["X"])
    assert all(torch.equal(got["state"][k], as_torch["state"][k])
               for k in ("chol", "B"))
    assert torch.equal(got["idx"], as_torch["idx"])
    assert got["idx"].dtype == torch.int32
    jgot = JCheckpointer(src).restore(4, as_jax)
    for leaf, want in zip(jax.tree_util.tree_leaves(jgot),
                          jax.tree_util.tree_leaves(a)):
        np.testing.assert_array_equal(np.asarray(leaf), want)


# -- resume -------------------------------------------------------------------------


def _resume_pair(tmp_path, Y, spec, stop, **fit_kw):
    """(uninterrupted, resumed): the fit run straight through, and the same
    fit stopped at `stop` and continued by a fresh estimator's resume()."""
    full = Embedding(spec, device="cpu").fit(Y, **fit_kw)
    part = spec.replace(max_iters=stop,
                        checkpoint_dir=str(tmp_path / "ck"))
    Embedding(part, device="cpu").fit(Y, **fit_kw)
    res = Embedding(part, device="cpu").resume(Y, max_iters=spec.max_iters,
                                               **fit_kw)
    return full, res


@pytest.mark.parametrize("backend,kind,strategy", [
    ("dense", "ee", "sd"),
    ("dense", "tsne", "sd"),
    ("dense", "ee", "lbfgs"),
    ("dense", "tsne", "cg"),
    ("sparse", "ee", "sd"),
    ("sparse", "tsne", "sd"),
    ("tree", "ee", "sd"),
    ("tree", "tsne", "sd"),
])
def test_resume_replays_uninterrupted_trace(tmp_path, Y, backend, kind,
                                            strategy):
    spec = EmbedSpec(kind=kind, lam=1.0 if kind == "tsne" else 50.0,
                     strategy=strategy, backend=backend, perplexity=8.0,
                     n_neighbors=20, n_negatives=8, max_iters=10, tol=0.0,
                     checkpoint_every=100)
    full, res = _resume_pair(tmp_path, Y, spec, stop=5)
    r, f = res.result_, full.result_
    assert r.resumed_from == 5 and r.n_iters == 5
    np.testing.assert_array_equal(r.energies[1:], f.energies[6:])
    np.testing.assert_array_equal(r.step_sizes, f.step_sizes[5:])
    assert torch.equal(res.embedding_, full.embedding_)
    if backend == "sparse":
        # a stochastic resume evaluates once more at the restored X
        np.testing.assert_allclose(r.energies[0], f.energies[5], rtol=1e-3)
    else:
        # a deterministic one starts from the checkpointed E
        assert r.energies[0] == f.energies[5]


def test_checkpoints_every_k_keep_three_and_resume_from_the_newest(tmp_path,
                                                                    Y):
    spec = EmbedSpec(kind="tsne", lam=1.0, backend="sparse", perplexity=8.0,
                     n_neighbors=20, max_iters=9, tol=0.0,
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    Embedding(spec, device="cpu").fit(Y)
    assert Checkpointer(spec.checkpoint_dir).all_steps() == [6, 8, 9]
    res = Embedding(spec, device="cpu").resume(Y, max_iters=11)
    assert res.result_.resumed_from == 9 and res.result_.n_iters == 2
    # a resume past the budget runs nothing and rewrites nothing
    again = Embedding(spec, device="cpu").resume(Y, max_iters=11)
    assert again.result_.n_iters == 0
    assert torch.equal(again.embedding_, res.embedding_)


def test_a_failed_checkpoint_write_raises(tmp_path, Y, monkeypatch):
    def refuse(path, arr):
        raise OSError("disk full")

    monkeypatch.setattr(ckmod.np, "save", refuse)
    spec = EmbedSpec(kind="ee", lam=50.0, backend="dense", perplexity=8.0,
                     max_iters=2, checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(OSError, match="disk full"):
        Embedding(spec, device="cpu").fit(Y)
    assert Checkpointer(spec.checkpoint_dir).all_steps() == []


def test_resume_needs_a_checkpoint_dir_and_data(Y):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Embedding(EmbedSpec(), device="cpu").resume(Y)
    with pytest.raises(ValueError, match="needs Y"):
        Embedding(EmbedSpec(checkpoint_dir="ck"), device="cpu").resume()


def test_resume_appends_contiguous_records(tmp_path, Y):
    """tests/test_obs.py::test_resume_appends_contiguous_records on the
    port: one contiguous iteration stream across the checkpoint."""
    tel_dir = str(tmp_path / "tel")
    spec = EmbedSpec(kind="ee", lam=50.0, strategy="sd", backend="sparse",
                     perplexity=4.0, n_neighbors=8, max_iters=12, tol=0.0,
                     checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every=100)
    Embedding(spec.replace(max_iters=6), device="cpu").fit(
        Y, telemetry=tel_dir)
    resumed = Embedding(spec, device="cpu").resume(Y, telemetry=tel_dir)
    assert resumed.result_.resumed_from == 6
    meta, _, records = load_jsonl(tel_dir + "/run.jsonl")
    assert [r.it for r in records] == list(range(1, 13))
    assert meta["resumed_from"] == 6 and meta["start_it"] == 6
    trace = json.loads((tmp_path / "tel" / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("solve-iter") == 6 and "checkpoint" in names


def test_sharded_resume_on_two_ranks(tmp_path, Y):
    """Rank 0 writes, both ranks restore the same step: each rank's resumed
    fit is its uninterrupted fit bit for bit, and the ranks agree."""
    fields = dict(kind="tsne", lam=1.0, strategy="sd",
                  backend="sparse-sharded", perplexity=8.0, n_neighbors=20,
                  n_negatives=8, max_iters=8, tol=0.0, checkpoint_every=100)
    out = worker.spawn_ranks(2, [("r", "resume", dict(
        spec_fields=fields, Y=Y, ckdir=str(tmp_path / "ck"), stop=4))],
        tmp_path / "ranks")
    for rank in out:
        full, res = rank["r"]["full"], rank["r"]["resumed"]
        assert res["resumed_from"] == 4 and res["n_iters"] == 4
        np.testing.assert_array_equal(res["energies"][1:],
                                      full["energies"][5:])
        np.testing.assert_array_equal(res["X"], full["X"])
    np.testing.assert_array_equal(out[0]["r"]["resumed"]["X"],
                                  out[1]["r"]["resumed"]["X"])


# -- the resumed trace against JAX's uninterrupted one ---------------------------


def test_dense_resumed_trace_matches_jax(tmp_path, Y):
    """Dense EE at lambda = 1 (tests/test_torch_api.py says why 1): the
    port's resumed energies against JAX's uninterrupted fit."""
    kw = dict(kind="ee", strategy="sd", backend="dense", lam=1.0,
              perplexity=8.0, max_iters=8, tol=0.0)
    jres = JEmbedding(JEmbedSpec(**kw)).fit(jnp.asarray(Y)).result_
    _, res = _resume_pair(tmp_path, Y, EmbedSpec(**kw), stop=4)
    assert res.result_.resumed_from == 4
    np.testing.assert_allclose(res.result_.energies, jres.energies[4:],
                               rtol=1e-4)


def test_sparse_resumed_trace_matches_jax(tmp_path, Y):
    """Sparse t-SNE at mu_scale = 1e-3 from JAX's graph and start with JAX's
    draws (carried in through fit_kw): the port's resumed energies, PCG
    counts and z against JAX's uninterrupted fit."""
    jspec = JEmbedSpec(kind="tsne", lam=1.0, strategy="sd", backend="sparse",
                       perplexity=8.0, max_iters=8, tol=0.0, n_neighbors=20,
                       n_negatives=8, mu_scale=1e-3)
    js = jsparse_affinities(jnp.asarray(Y), k=20, perplexity=8.0,
                            model="tsne")
    X0 = jspectral_init(jspec, js, Y.shape[0])
    jd = []
    jres = JEmbedding(jspec).fit(None, X0=X0, saff=js,
                                 callback=lambda it, X, e, d: jd.append(d)
                                 ).result_
    spec = convert.spec_from_jax_fields(dataclasses.asdict(jspec))
    n, m = Y.shape[0], spec.n_negatives

    def source(seed, it):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        return torch.tensor(np.asarray(
            1 + jax.random.choice(key, n - 1, shape=(m,), replace=False)),
            dtype=torch.int32)

    pd = []
    fit_kw = dict(X0=convert.embedding_from_numpy(X0, "cpu"),
                  saff=convert.saff_from_numpy(
                      js.graph.indices, js.graph.weights, js.rev.indices,
                      js.rev.weights, "cpu"),
                  shift_source=source)
    part = EmbedSpec(**{**dataclasses.asdict(spec), "max_iters": 4,
                        "checkpoint_dir": str(tmp_path / "ck")})
    Embedding(part, device="cpu").fit(None, **fit_kw)
    res = Embedding(part, device="cpu").resume(
        None, max_iters=8, callback=lambda it, X, e, d: pd.append(d),
        **fit_kw).result_
    assert res.resumed_from == 4 and res.n_iters == 4
    np.testing.assert_allclose(res.energies[1:], jres.energies[5:],
                               rtol=1e-4)
    assert [d["pcg_iters"] for d in pd] == [d["pcg_iters"] for d in jd[4:]]
    np.testing.assert_allclose([d["z_ema"] for d in pd],
                               [d["z_ema"] for d in jd[4:]], rtol=1e-4)

