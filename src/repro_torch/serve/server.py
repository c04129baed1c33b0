"""`EmbeddingServer`: embedding-as-a-service over a fitted `Embedding`.

Port of `repro/serve/server.py`.  Load a versioned artifact once, then
answer transform requests without a refit.  Three mechanisms make the
request path cheap and correct:

  * **micro-batching**: requests from any number of client threads ride a
    `MicroBatcher`; a batch closes at `max_batch` rows or after
    `max_delay_s`, so single-row requests still share the device's work;
  * **power-of-two buckets**: a batch of n rows is padded with copies of
    its first row to the next power of two (clamped to the max-batch
    bucket), so at most log2(max_batch) + 1 batch shapes ever run.  Each
    bucket has a cache key in the reference's form
    (`transform:<kind>:n<bucket>:k..:m..:float32:<device>`), and
    `cache_info()` counts hits and misses per key;
  * **the rowwise solver**: the server forces `TransformSpec(solver=
    'rowwise')`, whose every row's result is independent of the rest of its
    batch and of the padding rows (api/transform.py says how that holds on
    CUDA), so micro-batching and bucketing cannot change a response.

Per-request deadlines (`timeout_s`) are enforced while queued; `close()`
(or the context manager) drains the queue.  The server runs on its
estimator's device: CUDA unless the estimator was built or loaded with
``device="cpu"``.  With `telemetry=` (as `Embedding.fit` takes it,
`repro_torch.obs`) every request appends a `RequestRecord` (queue wait, the
batch's compute share, end-to-end latency) and each batch runs under a
``serve/batch`` span, activated again on the batcher's worker thread, which
starts with an empty context; `close()` finalizes it.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.api.spec import TransformSpec
from repro_torch.api.transform import (_resolve_k, resolve_transform_spec,
                                       transform_points)
from repro_torch.kernels.autotune import device_kind
from repro_torch.obs import RequestRecord, activate, resolve_telemetry, span

from .batching import MicroBatcher
from .metrics import LatencyStats


def batch_bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n, clamped to the max-batch bucket."""
    cap = 1 << max(0, int(max_batch - 1).bit_length())
    return min(cap, max(1, 1 << max(0, int(n - 1).bit_length())))


class EmbeddingServer:
    """Batched transform server over one fitted (or loaded) `Embedding`.

    `submit(y)` enqueues a single query (one (D,) row or an (r, D) block)
    and returns a Future; `transform(y)` is the blocking convenience.  The
    server never mutates the estimator: `embedding_` stays bit-identical no
    matter how many requests are served.
    """

    def __init__(self, embedding, spec: TransformSpec | None = None, *,
                 max_batch: int = 64, max_delay_s: float = 0.002,
                 timeout_s: float | None = None, telemetry=None):
        if getattr(embedding, "embedding_", None) is None:
            raise ValueError(
                "EmbeddingServer needs a fitted estimator (fit() or "
                "Embedding.load() first)")
        if getattr(embedding, "_Y_train", None) is None:
            raise ValueError(
                "EmbeddingServer needs the training Y on the estimator "
                "(snapshot artifact, or pass Y_train= to Embedding.load)")
        if spec is None:
            spec = TransformSpec(solver="rowwise")
        elif spec.solver != "rowwise":
            raise ValueError(
                "EmbeddingServer requires TransformSpec(solver='rowwise') - "
                "the engine solver couples rows through its global line "
                "search, so micro-batching would change responses")
        self.embedding = embedding
        self.spec = resolve_transform_spec(embedding.spec, spec)
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self.latency = LatencyStats()
        self._tel = resolve_telemetry(telemetry)
        self._last_compute_s = 0.0
        self._train = embedding._train_tensor()
        self._dim = int(self._train.shape[1])
        self._k = _resolve_k(embedding.spec, self.spec, self._train.shape[0],
                             embedding.spec.perplexity)
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._cache: dict[str, dict[str, int]] = {}
        self._batcher = MicroBatcher(
            self._process, max_batch=max_batch, max_delay_s=max_delay_s,
            name="embedding-serve")
        if self._tel is not None:
            self._tel.recorder.set_meta(
                serve=True, kind=embedding.spec.kind,
                n_train=int(embedding.embedding_.shape[0]),
                max_batch=max_batch)

    @classmethod
    def from_artifact(cls, path: str, spec: TransformSpec | None = None, *,
                      Y_train=None, device=None, **kw) -> "EmbeddingServer":
        """Serve straight from a saved artifact (`Embedding.save`) on
        `device` (None: CUDA)."""
        from repro_torch.api import Embedding
        return cls(Embedding.load(path, Y_train=Y_train, device=device), spec,
                   **kw)

    # -- request path --------------------------------------------------------
    def submit(self, y, *, timeout: float | None = None):
        """Enqueue one query — a (D,) row or an (r, D) block — and return a
        Future resolving to the (r, dim) embedding ((dim,) for a single
        row) as numpy.  `timeout` defaults to the server's `timeout_s`."""
        y = np.asarray(y, dtype=np.float32)
        single = y.ndim == 1
        rows = y[None, :] if single else y
        if rows.ndim != 2 or rows.shape[1] != self._dim:
            raise ValueError(
                f"query must be ({self._dim},) or (r, {self._dim}), got "
                f"shape {y.shape}")
        t_submit = time.perf_counter()
        with self._rid_lock:
            self._rid += 1
            rid = self._rid
        fut = self._batcher.submit(
            (rid, rows, t_submit, single),
            timeout=self.timeout_s if timeout is None else timeout)
        fut.add_done_callback(
            lambda f: self._finish(f, rid, rows.shape[0], t_submit))
        return fut

    def transform(self, y, *, timeout: float | None = None):
        """Blocking submit: the embedding for `y`, or raises the request's
        failure (TimeoutError past the deadline)."""
        return self.submit(y, timeout=timeout).result()

    def _finish(self, fut, rid: int, n_rows: int, t_submit: float) -> None:
        total = time.perf_counter() - t_submit
        err = None if fut.cancelled() else fut.exception()
        status = ("ok" if err is None
                  else "timeout" if isinstance(err, TimeoutError)
                  else "error")
        if status == "ok":
            self.latency.add(total)
        if self._tel is not None:
            ok = status == "ok"
            self._tel.recorder.record_request(RequestRecord(
                rid=rid, n_rows=n_rows,
                batch=self._batcher.stats.n_batches - 1,
                queue_s=max(0.0, total - self._last_compute_s) if ok
                else total,
                compute_s=self._last_compute_s if ok else 0.0,
                total_s=total, status=status))

    # -- batch side ----------------------------------------------------------
    def _cache_key(self, bucket: int) -> str:
        mm = "exh" if self.spec.exhaustive else str(self.spec.n_negatives)
        return (f"transform:{self.embedding.spec.kind}:n{bucket}:k{self._k}:"
                f"m{mm}:float32:{device_kind(self._train.device)}")

    def _process(self, payloads):
        rows = [p[1] for p in payloads]
        n = sum(r.shape[0] for r in rows)
        bucket = batch_bucket(n, self.max_batch)
        Y = np.concatenate(rows, axis=0)
        if bucket > n:
            # pad with copies of the first row: the rowwise solver makes
            # padded rows invisible to real ones (batch invariance); they
            # are sliced off before the split below
            Y = np.concatenate(
                [Y, np.repeat(Y[:1], bucket - n, axis=0)], axis=0)
        entry = self._cache.setdefault(self._cache_key(bucket),
                                       {"hits": 0, "misses": 0})
        entry["hits" if entry["hits"] + entry["misses"] else "misses"] += 1
        est = self.embedding
        t0 = time.perf_counter()
        # the batcher's worker thread starts with an empty context: the
        # server's tracer (if any) is activated again here
        with activate(self._tel.tracer if self._tel else None):
            with span("serve/batch", n=n, bucket=bucket,
                      requests=len(payloads)):
                X, _ = transform_points(est.spec, self._train,
                                        est.embedding_, Y, tspec=self.spec)
                X = X[:n].cpu().numpy()   # the batch's one result read
        self._last_compute_s = time.perf_counter() - t0
        out, off = [], 0
        for _, r, _, single in payloads:
            x = X[off:off + r.shape[0]]
            out.append(x[0] if single else x)
            off += r.shape[0]
        return out

    # -- lifecycle / introspection -------------------------------------------
    def warmup(self, batch_sizes=None) -> list[str]:
        """Run the bucketed transform once for the given batch sizes
        (default: every power-of-two bucket up to max_batch, i.e. every
        shape live traffic can hit), so that the first requests find the
        device's allocator and kernels warm; returns the cache keys
        touched."""
        if batch_sizes is None:
            batch_sizes = [1 << i for i in range(
                (self.max_batch - 1).bit_length() + 1)]
        anchor = self._train[:1].cpu().numpy()
        keys = []
        for b in batch_sizes:
            b = max(1, min(int(b), self.max_batch))
            self._process([(0, np.repeat(anchor, b, axis=0),
                            time.perf_counter(), False)])
            keys.append(self._cache_key(batch_bucket(b, self.max_batch)))
        return keys

    def cache_info(self) -> dict:
        """Per-bucket cache counters, keyed as the reference keys them."""
        return {k: dict(v) for k, v in self._cache.items()}

    def stats(self) -> dict:
        """Serving counters and latency percentiles (milliseconds)."""
        s = self._batcher.stats
        out = {"latency": self.latency.snapshot(),
               "cache": self.cache_info(), **s.as_dict()}
        if s.n_batches:
            out["mean_batch"] = s.n_rows / s.n_batches
        return out

    def close(self, *, drain: bool = True) -> None:
        self._batcher.close(drain=drain)
        if self._tel is not None:
            self._tel.finalize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
