"""The port's serving stack (repro_torch.serve): the reference's
tests/test_serve.py cases on the port, on the CPU (``device="cpu"``).

Micro-batching semantics (ordering, deadlines, error isolation, drain and
cancel), server parity with the direct transform under concurrent load at
the reference's 1e-5 (tests/test_serve.py:197,213), bucket padding, cache
keys and warmup, artifact-backed serving, the HTTP front-end in process and
as `python -m repro_torch.serve.http`, request telemetry (`telemetry=`),
and the refusals: the engine solver, a wrong dimension and a missing CUDA
device.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import CancelledError
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import Embedding, EmbedSpec, TransformSpec
from repro_torch.data import mnist_like
from repro_torch.serve import (BatchStats, EmbeddingServer, LatencyStats,
                               MicroBatcher, batch_bucket, percentile,
                               percentiles)
from repro_torch.serve.http import make_http_server

SRC = Path(__file__).resolve().parents[1] / "src"

# -- metrics --------------------------------------------------------------------


def test_percentile_nearest_rank():
    vals = [10.0, 20.0, 30.0, 40.0]
    assert percentile(vals, 50) == 20.0
    assert percentile(vals, 99) == 40.0
    assert percentile(vals, 0) == 10.0
    assert np.isnan(percentile([], 50))
    assert percentiles(vals) == {"p50": 20.0, "p90": 40.0, "p99": 40.0}


def test_latency_stats_snapshot():
    s = LatencyStats()
    assert s.snapshot() == {"n": 0}
    for v in (0.001, 0.002, 0.010):
        s.add(v)
    snap = s.snapshot()
    assert snap["n"] == 3 == len(s)
    assert snap["p50_ms"] == pytest.approx(2.0)
    assert snap["max_ms"] == pytest.approx(10.0)


def test_batch_bucket_pow2_saturating():
    assert [batch_bucket(n, 16) for n in (1, 2, 3, 5, 16, 40)] == \
        [1, 2, 4, 8, 16, 16]
    assert batch_bucket(7, 64) == 8 and batch_bucket(65, 64) == 64


# -- MicroBatcher ---------------------------------------------------------------


def test_microbatcher_batches_and_orders_results():
    seen = []

    def process(payloads):
        seen.append(len(payloads))
        return [p * 10 for p in payloads]

    with MicroBatcher(process, max_batch=4, max_delay_s=0.05) as mb:
        futs = [mb.submit(i) for i in range(10)]
        assert [f.result(timeout=10) for f in futs] == \
            [i * 10 for i in range(10)]
    assert sum(seen) == 10
    assert max(seen) <= 4
    assert isinstance(mb.stats, BatchStats)
    assert mb.stats.as_dict()["n_rows"] == 10


def test_microbatcher_deadline_timeout():
    release = threading.Event()

    def process(payloads):
        release.wait(5)
        return payloads

    mb = MicroBatcher(process, max_batch=1, max_delay_s=0.0)
    blocker = mb.submit("slow")          # occupies the worker
    time.sleep(0.05)
    doomed = mb.submit("late", timeout=0.01)
    time.sleep(0.1)                      # deadline passes while queued
    release.set()
    assert blocker.result(timeout=10) == "slow"
    with pytest.raises(TimeoutError, match="deadline"):
        doomed.result(timeout=10)
    assert mb.stats.n_timeouts == 1
    mb.close()


def test_microbatcher_error_isolation():
    def process(payloads):
        if "poison" in payloads:
            raise RuntimeError("boom")
        return payloads

    with MicroBatcher(process, max_batch=1, max_delay_s=0.0) as mb:
        bad = mb.submit("poison")
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(timeout=10)
        # the worker survived the poison request and keeps serving
        assert mb.submit("fine").result(timeout=10) == "fine"
    assert mb.stats.n_errors == 1


def test_microbatcher_close_drains_then_rejects():
    slow = threading.Event()

    def process(payloads):
        slow.wait(0.05)
        return payloads

    mb = MicroBatcher(process, max_batch=2, max_delay_s=0.0)
    futs = [mb.submit(i) for i in range(6)]
    mb.close(drain=True)
    assert [f.result(timeout=10) for f in futs] == list(range(6))
    with pytest.raises(RuntimeError, match="close"):
        mb.submit(99)


def test_microbatcher_close_cancel_mode():
    release = threading.Event()

    def process(payloads):
        release.wait(5)
        return payloads

    mb = MicroBatcher(process, max_batch=1, max_delay_s=0.0)
    running = mb.submit("running")
    time.sleep(0.05)
    queued = [mb.submit(i) for i in range(4)]
    # close() first so the worker sees cancel-mode before it can pick up the
    # queued requests; the timer then unblocks the in-flight batch
    threading.Timer(0.2, release.set).start()
    mb.close(drain=False)
    assert running.result(timeout=10) == "running"
    cancelled = 0
    for f in queued:
        try:
            f.result(timeout=10)
        except CancelledError:
            cancelled += 1
    assert cancelled == len(queued)


@pytest.mark.parametrize("kw,match", [({"max_batch": 0}, "max_batch"),
                                      ({"max_delay_s": -1}, "max_delay_s")])
def test_microbatcher_rejects_bad_config(kw, match):
    with pytest.raises(ValueError, match=match):
        MicroBatcher(lambda p: p, **kw)


def test_microbatcher_counts_every_submit_under_contention():
    """16 threads submitting at once with a tiny switch interval: no
    request count is lost and every result comes back to its caller."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with MicroBatcher(lambda p: [x + 1 for x in p], max_batch=8,
                          max_delay_s=0.001) as mb:
            out = {}

            def client(c):
                futs = [(i, mb.submit(c * 1000 + i)) for i in range(200)]
                out[c] = all(f.result(timeout=30) == c * 1000 + i + 1
                             for i, f in futs)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert out == {c: True for c in range(16)}
    assert mb.stats.n_requests == mb.stats.n_rows == 3200


# -- EmbeddingServer ------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted():
    Y, _ = mnist_like(n=160)
    est = Embedding(EmbedSpec(kind="ee", lam=10.0, strategy="sd",
                              backend="dense", perplexity=8.0,
                              n_neighbors=24, max_iters=15, tol=0.0, seed=0),
                    device="cpu")
    est.fit(Y[:128])
    return Y, est


TSPEC = TransformSpec(solver="rowwise", exhaustive=True, max_iters=10)


def test_server_requires_fitted_rowwise_and_no_telemetry(fitted):
    """The refusals; `telemetry=` (refused before the port had `obs`) is
    now taken: one ok request record, and the same rows as without it."""
    Y, est = fitted
    with pytest.raises(ValueError, match="fitted"):
        EmbeddingServer(Embedding(EmbedSpec(), device="cpu"))
    with pytest.raises(ValueError, match="rowwise"):
        EmbeddingServer(est, TransformSpec(solver="engine"))
    with EmbeddingServer(est, TSPEC, telemetry=True) as srv:
        got = srv.transform(Y[130])
    recs = srv._tel.recorder.requests
    assert [(r.rid, r.n_rows, r.status) for r in recs] == [(1, 1, "ok")]
    with EmbeddingServer(est, TSPEC) as srv:
        np.testing.assert_array_equal(srv.transform(Y[130]), got)


def test_server_concurrent_parity_with_direct_transform(fitted):
    """Responses under concurrent micro-batched load equal one direct
    transform() over the same rows."""
    Y, est = fitted
    Yq = Y[128:] + 0.01
    direct = est.transform(Yq, TSPEC).numpy()
    out = np.zeros_like(direct)
    with EmbeddingServer(est, TSPEC, max_batch=8, max_delay_s=0.005) as srv:
        srv.warmup()

        def client(idxs):
            for i in idxs:
                out[i] = srv.transform(Yq[i], timeout=120.0)

        threads = [threading.Thread(target=client,
                                    args=(range(c, len(Yq), 4),))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    stats = srv.stats()
    assert np.max(np.abs(out - direct)) <= 1e-5
    assert stats["n_requests"] == len(Yq)
    assert stats["n_batches"] < len(Yq)     # batching actually happened
    assert stats["latency"]["n"] == len(Yq)
    assert stats["mean_batch"] > 1


@pytest.mark.parametrize("exhaustive", [True, False])
def test_server_bucket_padding_is_response_invariant(fitted, exhaustive):
    """A block request that lands in a larger pow2 bucket (padded with
    row-0 copies) returns the same rows as the unpadded direct path."""
    Y, est = fitted
    tspec = TSPEC.replace(exhaustive=exhaustive)
    Yq = Y[128:133]                         # 5 rows -> bucket 8
    direct = est.transform(Yq, tspec).numpy()
    with EmbeddingServer(est, tspec, max_batch=16) as srv:
        got = srv.transform(Yq, timeout=120.0)
        info = srv.cache_info()
    assert got.shape == direct.shape
    assert np.max(np.abs(got - direct)) <= 1e-5
    assert list(info) == [f"transform:ee:n8:k24:"
                          f"m{'exh' if exhaustive else 50}:float32:cpu"]


def test_server_cache_keys_and_warmup(fitted):
    _, est = fitted
    with EmbeddingServer(est, TSPEC, max_batch=4) as srv:
        keys = srv.warmup()
        # one key per pow2 bucket up to max_batch
        assert keys == [f"transform:ee:n{b}:k24:mexh:float32:cpu"
                        for b in (1, 2, 4)]
        before = srv.cache_info()
        srv.transform(np.asarray(est._Y_train)[0], timeout=120.0)
        after = srv.cache_info()
    b1 = keys[0]
    assert before[b1] == {"hits": 0, "misses": 1}
    assert after[b1]["hits"] == before[b1]["hits"] + 1


def test_server_from_artifact(tmp_path, fitted):
    Y, est = fitted
    path = str(tmp_path / "m.npz")
    est.save(path)
    srv = EmbeddingServer.from_artifact(path, TSPEC, device="cpu",
                                        max_batch=4)
    try:
        direct = est.transform(Y[130:134], TSPEC).numpy()
        got = srv.transform(Y[130:134], timeout=120.0)
        assert np.max(np.abs(got - direct)) <= 1e-5
        assert srv.embedding.loaded_from_ == path
    finally:
        srv.close()
    assert srv.stats()["latency"]["n"] == 1


def test_server_rejects_wrong_dimension(fitted):
    _, est = fitted
    with EmbeddingServer(est, TSPEC) as srv:
        with pytest.raises(ValueError, match="query must be"):
            srv.submit(np.zeros(3))


def test_server_timeout_surfaces(fitted):
    _, est = fitted
    srv = EmbeddingServer(est, TSPEC, max_batch=1, max_delay_s=0.0,
                          timeout_s=1e-9)
    try:
        srv.warmup([1])
        # occupy the worker so the next request waits past its deadline
        futs = [srv.submit(np.asarray(est._Y_train)[0]) for _ in range(20)]
        outcomes = []
        for f in futs:
            try:
                f.result(timeout=60)
                outcomes.append("ok")
            except TimeoutError:
                outcomes.append("timeout")
        assert "timeout" in outcomes
    finally:
        srv.close()
    assert srv.stats()["n_timeouts"] >= 1


def test_server_leaves_the_estimator_untouched(fitted):
    Y, est = fitted
    before = est.embedding_.clone()
    with EmbeddingServer(est, TSPEC.replace(exhaustive=False),
                         max_batch=8) as srv:
        for f in [srv.submit(Y[128 + i]) for i in range(6)]:
            f.result(timeout=120)
    assert torch.equal(before, est.embedding_)


# -- HTTP front-end -------------------------------------------------------------


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_http_endpoints_end_to_end(fitted):
    Y, est = fitted
    srv = EmbeddingServer(est, TSPEC, max_batch=4)
    srv.warmup([1])
    httpd = make_http_server(srv, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        h = json.loads(urllib.request.urlopen(f"{base}/healthz",
                                              timeout=30).read())
        assert h == {"ok": True, "n_train": 128, "dim": 784, "kind": "ee"}
        Yq = Y[128:131]
        obj = json.loads(_post(f"{base}/transform",
                               json.dumps({"rows": Yq.tolist()}).encode())
                         .read())
        direct = est.transform(Yq, TSPEC).numpy()
        assert np.max(np.abs(np.asarray(obj["embedding"]) - direct)) <= 1e-5
        assert obj["n"] == 3
        st = json.loads(urllib.request.urlopen(f"{base}/stats",
                                               timeout=30).read())
        assert st["n_requests"] >= 1
        for body, code in ((b'{"rows": "nope"}', 400),
                           (json.dumps({"rows": [[0.0] * 3]}).encode(), 500)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/transform", body)
            assert e.value.code == code
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        t.join(timeout=30)
    assert not t.is_alive()


def _http_cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(SRC), **(env_extra or {}))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.http", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_http_cli_serves_an_artifact_and_drains_on_sigterm(tmp_path, fitted):
    """`python -m repro_torch.serve.http --device cpu` serves a saved
    artifact; SIGTERM drains and exits 0."""
    Y, est = fitted
    path = str(tmp_path / "m.npz")
    est.save(path)
    proc = _http_cli(["--artifact", path, "--device", "cpu", "--port", "0",
                      "--warmup", "1"])
    try:
        line = ""
        while "listening on" not in line:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
        base = line.split("listening on ")[1].split()[0]
        obj = json.loads(_post(f"{base}/transform",
                               json.dumps({"rows": Y[128:130].tolist()})
                               .encode()).read())
        direct = est.transform(Y[128:130],
                               TransformSpec(solver="rowwise")).numpy()
        assert np.max(np.abs(np.asarray(obj["embedding"]) - direct)) <= 1e-5
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained and closed" in out


def test_http_cli_needs_cuda_unless_told_otherwise(tmp_path, fitted):
    """Without `--device` the CLI serves on CUDA; with no CUDA device (here
    hidden) it exits with the estimator's error instead of using the
    CPU."""
    _, est = fitted
    path = str(tmp_path / "m.npz")
    est.save(path)
    proc = _http_cli(["--artifact", path, "--port", "0", "--no-warmup"],
                     {"CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in err
    assert "listening" not in out
