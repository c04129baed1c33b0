"""Generic micro-batching request queue — the serving core.

Port of `repro/serve/batching.py` (pure Python, copied; the request
counter is taken under a lock).  The accelerator wants batches; clients
send single requests.  The `MicroBatcher` sits between them: requests
enqueue from any thread and a single worker drains the queue into batches,
closing a batch when either `max_batch` requests are waiting or
`max_delay_s` has passed since the batch opened (the classic
latency/throughput knob pair).  One `process` callable — list of payloads
in, list of results out — is the only thing the owner supplies
(`repro_torch.serve.server` batches embedding transforms with it).

Contracts:

  * `submit` returns a `concurrent.futures.Future`; it never blocks on
    the accelerator.  Per-request deadlines (`timeout=`) are enforced at
    BATCH ASSEMBLY: a request whose deadline passed while queued gets
    `TimeoutError` and never wastes a batch slot.  Requests already in a
    running batch complete normally — compute is not cancelable.
  * `process` failures fail only that batch's futures (error isolation:
    a poison request cannot take the server down), and the worker keeps
    serving.
  * `close(drain=True)` is the graceful shutdown: no new submits, queued
    requests are processed, then the worker joins.  `drain=False` fails
    queued requests with `CancelledError`.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import CancelledError, Future
from typing import Any, Callable, Sequence


@dataclasses.dataclass
class _Pending:
    payload: Any
    future: Future
    t_submit: float
    deadline: float | None    # absolute perf_counter time, None = never


@dataclasses.dataclass
class BatchStats:
    """Mutable counters the worker maintains; snapshot via `as_dict`."""

    n_requests: int = 0
    n_batches: int = 0
    n_timeouts: int = 0
    n_errors: int = 0
    n_rows: int = 0          # payloads actually processed
    busy_s: float = 0.0      # cumulative `process` wall-clock

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class MicroBatcher:
    """Single-worker micro-batching queue (module docstring for the
    contracts).  `process(payloads) -> results` must return one result
    per payload, in order."""

    def __init__(self, process: Callable[[list], Sequence],
                 *, max_batch: int = 64, max_delay_s: float = 0.002,
                 name: str = "microbatch"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(
                f"max_delay_s must be >= 0, got {max_delay_s}")
        self.process = process
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.name = name
        self.stats = BatchStats()
        self._submit_lock = threading.Lock()
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._closed = threading.Event()
        self._drained = threading.Event()
        self._worker = threading.Thread(
            target=self._run, name=f"{name}-worker", daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------
    def submit(self, payload: Any, *, timeout: float | None = None
               ) -> Future:
        """Enqueue one request; the Future resolves to `process`'s result
        for this payload.  `timeout` (seconds) is a queue deadline — a
        request still waiting when it expires gets TimeoutError."""
        if self._closed.is_set():
            raise RuntimeError(f"{self.name}: submit() after close()")
        now = time.perf_counter()
        p = _Pending(payload=payload, future=Future(), t_submit=now,
                     deadline=None if timeout is None else now + timeout)
        with self._submit_lock:
            self.stats.n_requests += 1
        self._q.put(p)
        return p.future

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- worker side ---------------------------------------------------------
    def _expire(self, p: _Pending, now: float) -> bool:
        if p.deadline is not None and now > p.deadline:
            self.stats.n_timeouts += 1
            if not p.future.cancelled():
                p.future.set_exception(
                    TimeoutError(f"{self.name}: request waited "
                                 f"{now - p.t_submit:.3f}s in queue, "
                                 f"deadline exceeded"))
            return True
        return False

    def _collect(self) -> list[_Pending] | None:
        """Block for the first request, then fill the batch until
        max_batch or the batch window closes.  None = shut down."""
        while True:
            if self._closed.is_set() and not self._drain_on_close:
                return None          # cancel-mode close: stop immediately
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._closed.is_set():
                    return None
                continue
            now = time.perf_counter()
            if self._expire(first, now):
                continue
            batch = [first]
            window_end = now + self.max_delay_s
            while len(batch) < self.max_batch:
                remaining = window_end - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    p = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if not self._expire(p, time.perf_counter()):
                    batch.append(p)
            return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                break
            t0 = time.perf_counter()
            try:
                results = self.process([p.payload for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"{self.name}: process returned {len(results)} "
                        f"results for {len(batch)} payloads")
            except Exception as e:          # error isolation per batch
                self.stats.n_errors += len(batch)
                for p in batch:
                    if not p.future.cancelled():
                        p.future.set_exception(e)
                continue
            finally:
                dt = time.perf_counter() - t0
                self.stats.n_batches += 1
                self.stats.busy_s += dt
            self.stats.n_rows += len(batch)
            for p, r in zip(batch, results):
                if not p.future.cancelled():
                    p.future.set_result(r)
        # drain or fail whatever is still queued, then signal
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            if self._drain_on_close:
                now = time.perf_counter()
                if self._expire(p, now):
                    continue
                try:
                    r = self.process([p.payload])[0]
                    p.future.set_result(r)
                except Exception as e:
                    self.stats.n_errors += 1
                    p.future.set_exception(e)
            else:
                if not p.future.cancelled():
                    p.future.set_exception(
                        CancelledError(f"{self.name}: closed"))
        self._drained.set()

    _drain_on_close = True

    def close(self, *, drain: bool = True, timeout: float | None = 30.0
              ) -> None:
        """Graceful shutdown: refuse new submits, let the worker finish
        (processing the queue when `drain`, cancelling it otherwise), and
        join.  Idempotent."""
        self._drain_on_close = drain
        self._closed.set()
        self._worker.join(timeout=timeout)
        self._drained.wait(timeout=0 if timeout is None else timeout)
