"""The port's telemetry (repro_torch.obs) against the reference's repro.obs.

The reference's tests/test_obs.py cases on the port, on the CPU
(``device="cpu"``): the JSONL schema (each package reads the other's file),
the report CLI (each package renders the other's), spans and tracer
scoping, phase spans mirrored into the recorder, the `resolve_telemetry`
contract, the memory counters, the `on_iteration` hook and the profiler
annotations.  Then whole fits: a sparse EE and a t-SNE fit with telemetry
beside the same JAX fit (the port takes JAX's per-iteration draws; the
spectral start's signs do not change an energy), which must give the same
phase names, span names, meta keys, iteration count and `extras` keys, and
energies at rtol 1e-4 (the reference's trace tolerance, tests/test_api.py:
92); telemetry on vs off, bit for bit, on the dense, sparse and tree
backends; the server's request records, in process and through
`python -m repro_torch.serve.http --telemetry`.  The sparse fits run at
mu_scale = 1e-3, where the reference's own two paths agree (ROADMAP.md,
Queue 3).
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.obs as pobs
from repro import obs as jobs
from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.obs.report import main as jreport_main
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec, TransformSpec
from repro_torch.data import mnist_like
from repro_torch.embed.engine import fit_loop, make_loop_config
from repro_torch.embed.trainer import build_sparse_objective
from repro_torch.obs import (IterationRecord, RequestRecord, RunRecorder,
                             SpanTracer, Telemetry, activate, current_tracer,
                             device_memory_stats, load_jsonl, load_requests,
                             resolve_telemetry, span)
from repro_torch.obs.report import main as report_main
from repro_torch.serve import EmbeddingServer
from tests.conftest import three_loops

SRC = Path(__file__).resolve().parents[1] / "src"
PHASES = {"graph-build", "spectral-init", "setup", "compile"}


@pytest.fixture(scope="module")
def Y():
    return np.array(three_loops(n_per=24, loops=3, dim=8), dtype=np.float32)


def _jax_shift_source(n, m):
    """The reference's draw of iteration `it` (the engine's
    fold_in(PRNGKey(seed), it) of core/objectives.py's choice)."""
    def source(seed, it):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        return torch.tensor(np.asarray(
            1 + jax.random.choice(key, n - 1, shape=(m,), replace=False)),
            dtype=torch.int32)
    return source


def _sparse_pair_specs(kind, iters=5):
    jspec = JEmbedSpec(kind=kind, lam=50.0 if kind == "ee" else 1.0,
                       strategy="sd", backend="sparse", perplexity=8.0,
                       max_iters=iters, tol=0.0, n_neighbors=20,
                       n_negatives=8, mu_scale=1e-3)
    return jspec, convert.spec_from_jax_fields(dataclasses.asdict(jspec))


def _check_chrome_trace(trace: dict) -> list[str]:
    for e in trace["traceEvents"]:
        assert e["ph"] == "X"
        assert isinstance(e["ts"], (int, float)) and e["ts"] >= 0
        assert isinstance(e["dur"], (int, float)) and e["dur"] >= 0
        assert "pid" in e and "tid" in e
    return [e["name"] for e in trace["traceEvents"]]


# -- record / JSONL schema ------------------------------------------------------


def _write_run(pkg, path):
    """One run through `pkg`'s recorder (`repro.obs` or the port's)."""
    rec = pkg.RunRecorder(jsonl_path=str(path))
    rec.set_meta(backend="sparse", n=120)
    rec.record_phase("graph-build", 0.25)
    r0 = pkg.IterationRecord(it=1, energy=3.5, grad_norm=0.5, alpha=0.1,
                             n_evals=2, t=0.01, iter_s=0.01,
                             extras={"pcg_iters": 7.0, "pcg_residual": 1e-4})
    rec.record(r0)
    rec.record(pkg.IterationRecord(it=2, energy=3.0, grad_norm=0.4,
                                   alpha=0.2, n_evals=1, t=0.02,
                                   iter_s=0.01))
    rec.record_request(pkg.RequestRecord(
        rid=1, n_rows=2, batch=0, queue_s=0.001, compute_s=0.002,
        total_s=0.003))
    rec.close()
    return rec


def test_jsonl_schema_round_trip(tmp_path):
    path = tmp_path / "run.jsonl"
    rec = _write_run(pobs, path)
    meta, phases, records = load_jsonl(str(path))
    assert meta == {"backend": "sparse", "n": 120}
    assert phases == [{"name": "graph-build", "dur_s": 0.25}]
    assert records == rec.records
    assert records[1].extras == {}
    assert load_requests(str(path)) == rec.requests

    # append-only schema: unknown record types and keys are ignored
    with open(path, "a") as f:
        f.write(json.dumps({"type": "espresso", "shots": 2}) + "\n")
        f.write(json.dumps({**records[0].to_json(), "it": 3,
                            "a_future_key": "x"}) + "\n")
    assert [r.it for r in load_jsonl(str(path))[2]] == [1, 2, 3]
    s = rec.summary()
    assert s["n_iters"] == 2 and s["total_evals"] == 3
    assert s["n_requests"] == 1
    assert s["mean_pcg_iters"] == pytest.approx(7.0)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_jsonl_is_read_by_both_packages(tmp_path, writer):
    """A file either package writes, both packages read the same."""
    path = tmp_path / "run.jsonl"
    _write_run(jobs if writer == "repro" else pobs, path)
    jmeta, jphases, jrecs = jobs.load_jsonl(str(path))
    meta, phases, recs = pobs.load_jsonl(str(path))
    assert (meta, phases) == (jmeta, jphases)
    assert [r.to_json() for r in recs] == [r.to_json() for r in jrecs]
    assert ([dataclasses.asdict(r) for r in pobs.load_requests(str(path))]
            == [dataclasses.asdict(r) for r in jobs.load_requests(str(path))])


def test_device_memory_stats_is_empty_on_the_cpu():
    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(torch.device("cpu")) == {}
    assert device_memory_stats("not a device") == {}
    # no CUDA started in this process: nothing to report, nothing raised
    assert device_memory_stats() == {}


# -- spans / tracer ---------------------------------------------------------------


def test_span_is_noop_without_tracer():
    assert current_tracer() is None
    with span("anything", phase=True, n=3) as s:
        assert s is None                                # shared no-op


def test_tracer_collects_and_scopes():
    tr = SpanTracer()
    with activate(tr):
        assert current_tracer() is tr
        with span("outer", n=1):
            with span("inner"):
                pass
        with activate(tr):                              # reentrant
            with span("again"):
                pass
    assert current_tracer() is None
    names = [e["name"] for e in tr.to_chrome_trace()["traceEvents"]]
    assert set(names) == {"outer", "inner", "again"}
    ev = {e["name"]: e for e in tr.events}
    assert ev["outer"]["args"] == {"n": 1}
    assert ev["inner"]["ts"] >= ev["outer"]["ts"]
    assert ev["inner"]["dur"] <= ev["outer"]["dur"]


def test_phase_span_mirrors_into_recorder():
    rec = RunRecorder()
    tr = SpanTracer(recorder=rec)
    with activate(tr):
        with span("graph-build", phase=True):
            pass
        with span("not-a-phase"):
            pass
    assert [p["name"] for p in rec.phases] == ["graph-build"]


def test_profiler_annotations_mirror_spans_and_keep_errors():
    """With `profiler_annotations` a span is a `torch.profiler` user
    annotation too; an error raised inside the span still propagates, and
    the span is still recorded."""
    from torch.profiler import ProfilerActivity, profile

    tr = SpanTracer(profiler_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with activate(tr):
            with span("solve-iter", it=1):
                torch.ones(8).sum()
            with pytest.raises(ZeroDivisionError):
                with span("fails"):
                    1 / 0
    keys = {e.key for e in prof.key_averages()}
    assert {"solve-iter", "fails"} <= keys
    assert [e["name"] for e in tr.events] == ["solve-iter", "fails"]


def test_resolve_telemetry_contract(tmp_path):
    assert resolve_telemetry(None) is None
    assert resolve_telemetry(False) is None
    t = resolve_telemetry(True)
    assert isinstance(t, Telemetry) and t.jsonl is None and t.trace is None
    d = tmp_path / "runs"
    t = resolve_telemetry(str(d))
    assert d.is_dir()
    assert t.jsonl == str(d / "run.jsonl") and t.trace == str(d / "trace.json")
    t2 = Telemetry()
    assert resolve_telemetry(t2) is t2
    with pytest.raises(TypeError):
        resolve_telemetry(3.14)
    # the field names of the reference's Telemetry, but for its JAX hook
    ref = {f.name for f in dataclasses.fields(jobs.Telemetry)}
    port = {f.name for f in dataclasses.fields(Telemetry)}
    assert ref - port == {"jax_annotations"}
    assert port - ref == {"profiler_annotations"}
    assert set(pobs.__all__) == set(jobs.__all__)


# -- end-to-end: fits with telemetry, beside JAX's ------------------------------


@pytest.mark.parametrize("kind", ["ee", "tsne"])
def test_sparse_fit_telemetry_matches_jax(tmp_path, Y, kind):
    """The same phase names, span names, meta keys, iteration count and
    extras keys as the reference; energies at rtol 1e-4; the JSONL mirrors
    the diagnostics table; the trace is valid Chrome-trace JSON."""
    jspec, spec = _sparse_pair_specs(kind)
    jemb = JEmbedding(jspec).fit(jnp.asarray(Y), telemetry=True)
    out = tmp_path / "tel"
    emb = Embedding(spec, device="cpu").fit(
        Y, telemetry=str(out),
        shift_source=_jax_shift_source(Y.shape[0], spec.n_negatives))
    jt, tel = jemb.telemetry_, emb.telemetry_
    res = emb.result_
    assert res.n_iters == jemb.result_.n_iters == 5
    np.testing.assert_allclose(res.energies, jemb.result_.energies,
                               rtol=1e-4)
    phases = [p["name"] for p in tel.recorder.phases]
    assert phases == [p["name"] for p in jt.recorder.phases]
    assert set(phases) == PHASES
    assert ({e["name"] for e in tel.tracer.events}
            == {e["name"] for e in jt.tracer.events})
    assert set(tel.recorder.meta) == set(jt.recorder.meta)
    assert tel.recorder.meta["kernel_dispatch"]["ell_lap_matvec"] == {
        "path": "torch", "reason": "cpu-tensor", "storage": "float32"}
    want_keys = {"pcg_iters", "pcg_residual"} | (
        {"z_ema"} if kind == "tsne" else set())
    for r, jr in zip(tel.recorder.records, jt.recorder.records):
        assert set(r.extras) == set(jr.extras) == want_keys
        assert r.extras["pcg_iters"] >= 1
        if kind == "tsne":
            assert r.extras["z_ema"] > 0

    # the diagnostics table, the JSONL file and the recorder agree
    assert [d["it"] for d in res.diagnostics] == list(range(1, 6))
    meta, jphases, records = load_jsonl(str(out / "run.jsonl"))
    assert meta["backend"] == "sparse" and meta["strategy"] == "sd"
    assert records == tel.recorder.records
    assert [p["name"] for p in jphases] == phases
    names = _check_chrome_trace(json.loads((out / "trace.json").read_text()))
    assert names.count("solve-iter") == 5
    assert "kernel/ell_lap_matvec" in names
    assert tel.summary()["mean_pcg_iters"] >= 1


@pytest.mark.parametrize("backend,kind", [("dense", "tsne"),
                                          ("sparse", "tsne"),
                                          ("tree", "ee")])
def test_telemetry_on_vs_off_is_bit_identical(Y, backend, kind):
    spec = EmbedSpec(kind=kind, lam=1.0 if kind == "tsne" else 50.0,
                     strategy="sd", backend=backend, perplexity=8.0,
                     n_neighbors=20, max_iters=4, tol=0.0)
    off = Embedding(spec, device="cpu").fit(Y)
    on = Embedding(spec, device="cpu").fit(Y, telemetry=True)
    np.testing.assert_array_equal(on.result_.energies, off.result_.energies)
    assert torch.equal(on.embedding_, off.embedding_)
    assert len(on.telemetry_.recorder.records) == 4
    kernel = {"dense": "kernel/pairwise_terms", "sparse":
              "kernel/ell_lap_matvec", "tree": "kernel/bh_tree"}[backend]
    assert kernel in {e["name"] for e in on.telemetry_.tracer.events}


def test_no_telemetry_means_no_diagnostics(Y):
    emb = Embedding(_sparse_pair_specs("ee", iters=3)[1],
                    device="cpu").fit(Y)
    assert emb.result_.diagnostics is None
    assert emb.telemetry_ is None


def test_on_iteration_hook(Y):
    hits = []
    spec = _sparse_pair_specs("ee", iters=3)[1]
    obj, X0, _ = build_sparse_objective(spec, Y, strategy="sd",
                                        device="cpu")
    res = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()),
                   on_iteration=lambda it, X, diag: hits.append((it, diag)))
    assert [it for it, _ in hits] == [1, 2, 3]
    assert all(d["pcg_iters"] >= 1 for _, d in hits)
    assert res.diagnostics is not None                  # hook implies diag


# -- report CLI -------------------------------------------------------------------


def test_report_cli_renders_and_diffs_both_packages(tmp_path, Y, capsys):
    """Each package's report renders the other's run; the port's diffs a
    reference run against its own."""
    jspec, spec = _sparse_pair_specs("tsne", iters=3)
    JEmbedding(jspec).fit(jnp.asarray(Y), telemetry=str(tmp_path / "j"))
    Embedding(spec, device="cpu").fit(Y, telemetry=str(tmp_path / "p"))
    run_j, run_p = (str(tmp_path / d / "run.jsonl") for d in "jp")

    for main, path in ((report_main, run_p), (report_main, run_j),
                       (jreport_main, run_p)):
        assert main([path]) == 0
        text = capsys.readouterr().out
        assert "pcg_iters" in text and "graph-build" in text
        assert "z_ema" in text

    assert report_main([run_j, run_p]) == 0
    text = capsys.readouterr().out
    assert "phase:graph-build" in text and "mean_pcg_iters" in text
    assert report_main([run_p, run_p, "--json"]) == 0
    diff = json.loads(capsys.readouterr().out)
    assert diff["a"]["mean_pcg_iters"] == diff["b"]["mean_pcg_iters"]
    assert diff["a"]["n_iters"] == 3


# -- serving ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    Yd, _ = mnist_like(n=160)
    est = Embedding(EmbedSpec(kind="ee", lam=10.0, strategy="sd",
                              backend="dense", perplexity=8.0,
                              max_iters=10, tol=0.0), device="cpu")
    est.fit(Yd[:128])
    return Yd, est


TSPEC = TransformSpec(solver="rowwise", exhaustive=True, max_iters=10)


def test_server_writes_request_records_and_batch_spans(tmp_path, served):
    """One `RequestRecord` a request and one ``serve/batch`` span a batch
    (warmup batches included); the rows equal the server's without
    telemetry."""
    Yd, est = served
    out = tmp_path / "tel"
    with EmbeddingServer(est, TSPEC, max_batch=4,
                         telemetry=str(out)) as srv:
        srv.warmup([1])
        futs = [srv.submit(Yd[128 + i]) for i in range(6)]
        got = np.stack([f.result(timeout=60) for f in futs])
    stats = srv.stats()
    with EmbeddingServer(est, TSPEC, max_batch=4) as plain:
        want = np.stack([plain.transform(Yd[128 + i]) for i in range(6)])
    np.testing.assert_array_equal(got, want)
    recs = load_requests(str(out / "run.jsonl"))
    assert sorted(r.rid for r in recs) == list(range(1, 7))
    assert all(r.status == "ok" and r.n_rows == 1 for r in recs)
    assert all(0 <= r.batch < stats["n_batches"] for r in recs)
    assert all(r.total_s >= r.compute_s >= 0 for r in recs)
    names = _check_chrome_trace(json.loads((out / "trace.json").read_text()))
    assert names.count("serve/batch") == stats["n_batches"] + 1
    meta = load_jsonl(str(out / "run.jsonl"))[0]
    assert meta["serve"] is True and meta["n_train"] == 128


def test_http_cli_telemetry_writes_request_records(tmp_path, served):
    """`python -m repro_torch.serve.http --telemetry DIR` appends one request
    record a request to DIR/run.jsonl and writes DIR/trace.json when it
    drains."""
    Yd, est = served
    path = str(tmp_path / "m.npz")
    est.save(path)
    tel = tmp_path / "tel"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.http", "--artifact", path,
         "--device", "cpu", "--port", "0", "--no-warmup", "--telemetry",
         str(tel)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = ""
        while "listening on" not in line:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
        base = line.split("listening on ")[1].split()[0]
        for rows in (Yd[128:130], Yd[130:131]):
            req = urllib.request.Request(
                f"{base}/transform",
                data=json.dumps({"rows": rows.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=60).read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    recs = load_requests(str(tel / "run.jsonl"))
    assert [(r.n_rows, r.status) for r in recs] == [(2, "ok"), (1, "ok")]
    # the reference reads the port's request log too
    assert len(jobs.load_requests(str(tel / "run.jsonl"))) == 2
    names = _check_chrome_trace(json.loads((tel / "trace.json").read_text()))
    assert names.count("serve/batch") == 2


def test_iteration_record_json_keys_match_the_reference():
    r = IterationRecord(it=1, energy=1.0, grad_norm=2.0, alpha=0.5,
                        n_evals=1, t=0.1, iter_s=0.1, extras={"a": 1.0})
    j = jobs.IterationRecord(it=1, energy=1.0, grad_norm=2.0, alpha=0.5,
                             n_evals=1, t=0.1, iter_s=0.1, extras={"a": 1.0})
    assert r.to_json() == j.to_json()
    q = RequestRecord(rid=1, n_rows=1, batch=0, queue_s=0.0, compute_s=0.0,
                      total_s=0.0)
    assert q.to_json() == jobs.RequestRecord(**dataclasses.asdict(q)
                                             ).to_json()
