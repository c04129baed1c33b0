"""The port's autotuner (repro_torch/kernels/autotune.py) and the ops.py
dispatch that consumes it, on the CPU: the counterparts of the twelve tests
of tests/test_kernels_autotune.py with fake runners (first search wins,
all-`inf` falls back to the first candidate, bucket caps, key fields, the
disk round trip, foreign entries kept, the fixed shape always a candidate,
the staged gather's candidates, legal launch shapes, dispatch records and
their telemetry meta), plus: a cache file shared with the JAX package's
autotuner keeps both packages' entries in either order of writing, a CPU
dispatch searches nothing, a search's launches are counted apart, and a
miss during CUDA-graph capture raises.

The kernel path needs a card, so the dispatch tests stand in CPU fakes for
the wrappers' launchers (the plain version's output, the launch shape
recorded); tests/test_torch_kernels_cuda.py holds every candidate of every
kernel bit-equal to the fixed shape on the card.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.autotune import KernelConfig
from repro_torch.kernels.autotune import ell_lanes, slot_bucket
from repro_torch.kernels.ref import ell_lap_matvec_ref
from repro_torch.obs import RunRecorder, SpanTracer, activate


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_cache()
    jautotune.clear_cache()
    yield
    autotune.clear_cache()
    jautotune.clear_cache()


def _ok_runner(cfg, bucket_n):
    return lambda: torch.zeros(())


def _graph(seed: int, n: int, k: int, d: int):
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, n, size=(n, k)), dtype=torch.int32)
    w = torch.tensor(rng.random(size=(n, k)), dtype=torch.float32)
    return X, idx, w


# -- search + in-process cache --------------------------------------------------


def test_first_search_wins_and_same_key_hits_cache():
    cands = [KernelConfig(block_rows=8), KernelConfig(block_rows=16)]
    searched = []

    def runner(cfg, bucket_n):
        def thunk():
            searched.append(cfg.block_rows)
            if cfg.block_rows == 8:        # scores inf -> 16 must win
                raise RuntimeError("candidate fails")
            return torch.zeros(())
        return thunk

    cfg1, hit1 = autotune.get_config("ell", n=100, k=4, d=2,
                                     candidates=cands, runner=runner)
    assert cfg1 == KernelConfig(block_rows=16) and not hit1
    n_runs = len(searched)
    assert n_runs > 0
    # same bucket (70 and 100 both round up to 128): cache hit, no re-run
    cfg2, hit2 = autotune.get_config("ell", n=70, k=4, d=2,
                                     candidates=cands, runner=runner)
    assert hit2 and cfg2 == cfg1 and len(searched) == n_runs


def test_all_candidates_failing_falls_back_to_first():
    cands = [KernelConfig(block_rows=8), KernelConfig(block_rows=16)]

    def runner(cfg, bucket_n):
        def thunk():
            raise RuntimeError("nothing launches")
        return thunk

    cfg, hit = autotune.get_config("ell", n=32, k=2, d=2,
                                   candidates=cands, runner=runner)
    assert cfg == cands[0] and not hit
    # the failure is cached — paid once
    _, hit2 = autotune.get_config("ell", n=32, k=2, d=2,
                                  candidates=cands, runner=runner)
    assert hit2


def test_shape_bucket_pow2_and_caps():
    assert autotune.shape_bucket("ell", 1) == 8
    assert autotune.shape_bucket("ell", 100) == 128
    assert autotune.shape_bucket("ell", 128) == 128
    assert autotune.shape_bucket("ell", 129) == 256
    # the caps: many waves of the card's 132 SMs deep at every candidate
    assert autotune.shape_bucket("pairwise", 20000) == 16384
    assert autotune.shape_bucket("pairwise", 10**6) == 16384
    # a kind shares its kernel's cap
    assert autotune.shape_bucket("pairwise.tsne", 20000) == 16384
    for kernel in ("ell", "ell_hbm", "ell_local", "bh", "bh_tree"):
        assert autotune.shape_bucket(kernel, 70000) == 65536
        assert autotune.shape_bucket(kernel, 35000) == 65536
    assert autotune.shape_bucket("ell", 20000) == 32768


def test_cache_key_fields():
    """Kernel, bucket, k, d and dtype each change the key; the device kind
    is the device's name (here the CPU's) and the mode always compiled, in
    the reference's key layout."""
    base = dict(n=100, k=4, d=2)
    keys = {
        autotune.cache_key("ell", **base),
        autotune.cache_key("ell", **base, dtype="bfloat16"),
        autotune.cache_key("ell", n=100, k=8, d=2),
        autotune.cache_key("ell", n=100, k=4, d=3),
        autotune.cache_key("ell", n=1000, k=4, d=2),
        autotune.cache_key("ell_hbm", **base),
        autotune.cache_key("pairwise.ee", **base),
        autotune.cache_key("pairwise.tsne", **base),
    }
    assert len(keys) == 8
    assert (autotune.cache_key("ell", **base)
            == "ell:n128:k4:d2:float32:cpu:compiled")
    assert autotune.device_kind(torch.device("cpu")) == "cpu"
    # the reference's layout: a JAX key of the same request has the same
    # fields in the same order
    assert (jautotune.cache_key("ell", **base).split(":")[:5]
            == autotune.cache_key("ell", **base).split(":")[:5])


# -- disk cache -----------------------------------------------------------------


def test_disk_cache_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.clear_cache()
    cands = [KernelConfig(block_rows=32)]
    cfg, hit = autotune.get_config("ell", n=64, k=4, d=2,
                                   candidates=cands, runner=_ok_runner)
    assert not hit
    payload = json.loads(path.read_text())
    assert payload["version"] == 1 and payload["entries"]
    assert KernelConfig.from_json(
        next(iter(payload["entries"].values()))) == cfg

    # a fresh process: the in-process cache gone, the disk survives — a
    # re-search would blow up in the runner
    autotune.clear_cache()

    def boom(cfg, bucket_n):
        raise AssertionError("disk-cached key must not re-search")

    cfg2, hit2 = autotune.get_config("ell", n=64, k=4, d=2,
                                     candidates=cands, runner=boom)
    assert hit2 and cfg2 == cfg


def test_disk_cache_merge_preserves_foreign_entries(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    foreign = {"ell:n8:k1:d1:float32:tpu-v5-lite:compiled":
               KernelConfig(block_rows=8).to_json()}
    path.write_text(json.dumps({"version": 1, "entries": foreign}))
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.clear_cache()
    autotune.get_config("ell", n=64, k=4, d=2,
                        candidates=[KernelConfig(block_rows=16)],
                        runner=_ok_runner)
    entries = json.loads(path.read_text())["entries"]
    assert set(foreign) <= set(entries) and len(entries) == 2


@pytest.mark.parametrize("jax_first", [True, False],
                         ids=["jax-then-torch", "torch-then-jax"])
def test_cache_file_shared_with_the_jax_package(tmp_path, monkeypatch,
                                                jax_first):
    """One REPRO_AUTOTUNE_CACHE file written by repro.kernels.autotune and
    by the port, in either order, keeps both packages' entries, and each
    package then finds its own entry there without searching."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))

    def jax_search():
        jautotune.clear_cache()
        return jautotune.get_config(
            "ell", n=64, k=4, d=2,
            candidates=[jautotune.KernelConfig(block_rows=16)],
            runner=lambda cfg, b: (lambda: jnp.zeros(())))[0]

    def torch_search():
        autotune.clear_cache()
        return autotune.get_config(
            "ell", n=64, k=90, d=2,
            candidates=[KernelConfig(block_rows=8, chunk=4)],
            runner=_ok_runner)[0]

    first, second = ((jax_search, torch_search) if jax_first
                     else (torch_search, jax_search))
    first()
    second()
    entries = json.loads(path.read_text())["entries"]
    jkey = jautotune.cache_key("ell", n=64, k=4, d=2)
    tkey = autotune.cache_key("ell", n=64, k=90, d=2)
    assert {jkey, tkey} <= set(entries) and len(entries) == 2

    def boom(cfg, bucket_n):
        raise AssertionError("a cached key must not re-search")

    autotune.clear_cache()
    jautotune.clear_cache()
    assert autotune.get_config("ell", n=64, k=90, d=2,
                               candidates=[KernelConfig(block_rows=4)],
                               runner=boom) == (
        KernelConfig(block_rows=8, chunk=4), True)
    assert jautotune.get_config(
        "ell", n=64, k=4, d=2,
        candidates=[jautotune.KernelConfig(block_rows=8)],
        runner=boom) == (jautotune.KernelConfig(block_rows=16), True)


# -- candidates -----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 5, 16, 17, 32, 64, 90, 128, 229, 386])
def test_candidates_always_include_the_fixed_shape_first(k):
    """A tuned pick loses to the fixed launch only by noise, and the fixed
    launch is the fallback: it is every list's first candidate (the direct
    gather's 256 threads a block at the bucket P, the staged gather's four
    warps walking 8 row groups, csrc/ell.cu's defaults)."""
    S = ell_lanes(k)
    fixed = {"vmem": KernelConfig(block_rows=256 // S, layout="vmem",
                                  chunk=slot_bucket(k)),
             "hbm": KernelConfig(block_rows=4 * 8 * (32 // S), layout="hbm",
                                 chunk=8)}
    for layout in ("vmem", "hbm"):
        cands = autotune.ell_candidates(k=k, layouts=[layout])
        assert cands[0] == fixed[layout]
        assert len(set(cands)) == len(cands)
    for d in (1, 2, 4, 6):
        assert autotune.pairwise_candidates(d=d)[0] == KernelConfig(
            block_rows=8, block_cols=1024, layout="tiled")
    for width in (1, 25, 96, 128):
        assert autotune.bh_candidates(width=width)[0] == KernelConfig(
            block_rows=256 // autotune.bh_lanes(width))
    assert autotune.bh_tree_candidates()[0] == KernelConfig(block_rows=8)


@pytest.mark.parametrize("k", [3, 12, 24, 90, 229])
def test_hbm_candidates_are_warps_and_spans(k):
    """The staged gather's block_rows is warps x span x 32 / S, with 1-8
    warps a block (csrc/ell.cu); chunk is the span."""
    per_group = 32 // ell_lanes(k)
    cands = autotune.ell_candidates(k=k, layouts=["hbm"])
    assert len(cands) == 9
    for cfg in cands:
        assert cfg.layout == "hbm" and cfg.chunk > 0
        assert cfg.block_rows % (cfg.chunk * per_group) == 0
        assert 1 <= cfg.block_rows // (cfg.chunk * per_group) <= 8


def test_candidates_are_legal_launch_shapes():
    """Every candidate lies inside what its kernel's entry point takes
    (the C side returns cudaErrorInvalidValue outside it): pairwise 1-16
    rows and tiles that are multiples of 256 columns within 48 KB; the
    direct gather rows x S threads a multiple of 32 up to 512 and P in
    {1, 2, 4, 8}, P = 1 below S = 32; the per-batch Barnes-Hut kernel the
    same threads; the fused tree kernel 1-16 rows."""
    for d in (2, 4, 6):
        for cfg in autotune.pairwise_candidates(d=d):
            assert 1 <= cfg.block_rows <= 16
            assert cfg.block_cols % 256 == 0
            assert 4 * min(d, 4) * cfg.block_cols <= 48 * 1024
    for k in (1, 4, 8, 16, 17, 90, 229, 386):
        S = ell_lanes(k)
        ps = {cfg.chunk for cfg in autotune.ell_candidates(
            k=k, layouts=["vmem"])}
        assert ps <= {1, 2, 4, 8} and (S == 32 or ps == {1})
        for cfg in autotune.ell_candidates(k=k, layouts=["vmem"]):
            t = cfg.block_rows * S
            assert t % 32 == 0 and 32 <= t <= 512
    for width in (1, 8, 25, 96):
        S = autotune.bh_lanes(width)
        for cfg in autotune.bh_candidates(width=width):
            t = cfg.block_rows * S
            assert t % 32 == 0 and 32 <= t <= 512
    assert all(1 <= c.block_rows <= 16
               for c in autotune.bh_tree_candidates())


# -- launches and capture -------------------------------------------------------


def test_search_launches_are_counted_apart():
    counts = {"k": 0}

    def runner(cfg, bucket_n):
        return lambda: autotune.count_launch(counts, "k")

    before = dict(autotune.search_launches)
    autotune.get_config("ell", n=64, k=4, d=2, runner=runner,
                        candidates=[KernelConfig(block_rows=8),
                                    KernelConfig(block_rows=16)])
    assert counts == {"k": 0}
    assert autotune.search_launches["k"] - before.get("k", 0) >= 2
    autotune.count_launch(counts, "k")      # outside a search: the wrapper's
    assert counts == {"k": 1}


def test_miss_during_graph_capture_raises(monkeypatch):
    """A search never runs inside CUDA-graph capture: a miss raises and
    names the fix; a hit still returns."""
    cands = [KernelConfig(block_rows=8)]
    autotune.get_config("ell", n=64, k=4, d=2, candidates=cands,
                        runner=_ok_runner)
    monkeypatch.setattr(autotune, "_capturing", lambda: True)
    assert autotune.get_config("ell", n=64, k=4, d=2, candidates=cands,
                               runner=_ok_runner)[1]
    with pytest.raises(RuntimeError, match="eager call"):
        autotune.get_config("ell", n=64, k=8, d=2, candidates=cands,
                            runner=_ok_runner)


# -- ops dispatch consuming the autotuner ---------------------------------------


@pytest.fixture
def fake_kernel_path(monkeypatch):
    """ops' kernel path on CPU tensors: `_path` says kernel, and the ELL
    launchers compute the plain version, recording each launch shape."""
    shapes = []

    def launcher(X, idx, w, *, layout="vmem", block_rows=None, chunk=None):
        out = torch.empty((X.shape[0], X.shape[1]))

        def launch():
            out.copy_(ell_lap_matvec_ref(X.float(), idx, w.float()))
            shapes.append((layout, block_rows, chunk))
            autotune.count_launch({"fake": 0}, "fake")
        return launch, out

    def cuda(X, idx, w, *, layout="vmem", block_rows=None, chunk=None):
        launch, out = launcher(X, idx, w, layout=layout,
                               block_rows=block_rows, chunk=chunk)
        launch()
        return out

    monkeypatch.setattr(ops, "_path", lambda impl, X: (
        ("torch", "forced-off") if impl == "torch"
        else ("kernel", "forced-on")))
    monkeypatch.setattr(ops, "ell_launcher", launcher)
    monkeypatch.setattr(ops, "ell_lap_matvec_cuda", cuda)
    return shapes


def test_ops_autotuned_ell_deterministic_and_correct(fake_kernel_path):
    X, idx, w = _graph(11, 48, 40, 3)
    out1 = ops.ell_lap_matvec(X, idx, w, impl="kernel")
    d1 = dict(ops.last_dispatch("ell_lap_matvec"))
    n_searched = len(fake_kernel_path)
    out2 = ops.ell_lap_matvec(X, idx, w, impl="kernel")
    d2 = dict(ops.last_dispatch("ell_lap_matvec"))
    assert d1["path"] == "kernel" and d1["autotuned"]
    assert not d1["cache_hit"] and d2["cache_hit"]
    assert (d2["block_rows"], d2["chunk"]) == (d1["block_rows"], d1["chunk"])
    # the second call launched once, at the cached shape: no search
    assert fake_kernel_path[n_searched:] == [
        ("vmem", d1["block_rows"], d1["chunk"])]
    assert KernelConfig(block_rows=d1["block_rows"], layout="vmem",
                        chunk=d1["chunk"]) in autotune.ell_candidates(
        k=40, layouts=["vmem"])
    r = ell_lap_matvec_ref(X, idx, w)
    np.testing.assert_allclose(out1.numpy(), r.numpy(), rtol=5e-5,
                               atol=5e-5)
    assert torch.equal(out1, out2)


def test_dispatch_reasons_recorded(monkeypatch):
    X, idx, w = _graph(12, 32, 4, 2)
    ops.ell_lap_matvec(X, idx, w)                       # auto on CPU
    assert ops.last_dispatch("ell_lap_matvec") == {
        "path": "torch", "reason": "cpu-tensor", "storage": "float32"}
    ops.ell_lap_matvec(X, idx, w, impl="torch")
    assert ops.last_dispatch("ell_lap_matvec")["reason"] == "forced-off"
    with pytest.raises(ValueError, match="CUDA"):
        ops.ell_lap_matvec(X, idx, w, impl="kernel")


def test_explicit_launch_shape_is_not_autotuned(fake_kernel_path):
    X, idx, w = _graph(14, 32, 4, 2)
    ops.ell_lap_matvec(X, idx, w, impl="kernel", block_rows=16)
    disp = ops.last_dispatch("ell_lap_matvec")
    assert disp["path"] == "kernel" and disp["reason"] == "forced-on"
    assert not disp["autotuned"] and not disp["cache_hit"]
    # the unset chunk takes the fixed shape's
    assert (disp["block_rows"], disp["chunk"]) == (16, 1)
    assert fake_kernel_path == [("vmem", 16, 1)]
    assert autotune.cached_entries() == {}


def test_dispatch_lands_in_telemetry_meta(fake_kernel_path):
    X, idx, w = _graph(13, 32, 4, 2)
    rec = RunRecorder()
    with activate(SpanTracer(recorder=rec)):
        ops.ell_lap_matvec(X, idx, w, impl="kernel", block_rows=16)
        kd = dict(rec.meta["kernel_dispatch"]["ell_lap_matvec"])
        ops.ell_lap_matvec(X, idx, w, impl="torch")
    assert kd["path"] == "kernel" and kd["block_rows"] == 16
    assert not kd["autotuned"]
    kd = rec.meta["kernel_dispatch"]["ell_lap_matvec"]
    assert kd["path"] == "torch" and kd["reason"] == "forced-off"


def test_cpu_dispatch_searches_nothing():
    """The plain path (CPU tensors under impl="auto") runs no search and
    records no launch shape."""
    rng = np.random.default_rng(0)
    n = 40
    X = torch.tensor(rng.normal(size=(n, 2)), dtype=torch.float32)
    W = torch.tensor(np.abs(rng.normal(size=(n, n))), dtype=torch.float32)
    W = 0.5 * (W + W.T)
    W.fill_diagonal_(0.0)
    _, idx, w = _graph(1, n, 6, 2)
    before = autotune.n_searches
    ops.pairwise_terms(X, W, W, "tsne")
    ops.ell_lap_matvec(X, idx, w)
    ops.ell_lap_matvec(X, idx, w, layout="hbm")
    ops.ell_lap_matvec_local(X, idx[:20], w[:20], 20)
    ops.bh_interaction(X, idx, w, X, "ee")
    assert autotune.n_searches == before
    assert autotune.cached_entries() == {}
    for name in ("pairwise_terms", "ell_lap_matvec", "ell_lap_matvec_local",
                 "bh_interaction"):
        rec = ops.last_dispatch(name)
        assert rec["path"] == "torch" and "autotuned" not in rec
        assert "block_rows" not in rec
