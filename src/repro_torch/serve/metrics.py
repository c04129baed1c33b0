"""Latency accounting shared by the serving stack.

Port of `repro/serve/metrics.py` (pure Python, copied): one nearest-rank
percentile implementation feeds the `EmbeddingServer` stats endpoint and
`chip_smoke.py`'s serving report, so their numbers compare with the
reference's.
"""
from __future__ import annotations

import math
import threading


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of an unsorted sequence:
    ceil(q/100 * n) clamped to the data.  Deterministic, no interpolation
    — p99 of 10 samples is the largest sample, which is the honest answer
    at small n."""
    vals = sorted(values)
    if not vals:
        return float("nan")
    rank = max(1, min(len(vals), math.ceil(q / 100.0 * len(vals))))
    return float(vals[rank - 1])


def percentiles(values, qs=(50, 90, 99)) -> dict:
    return {f"p{int(q)}": percentile(values, q) for q in qs}


class LatencyStats:
    """Thread-safe latency accumulator (seconds in, milliseconds out)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._vals: list[float] = []

    def add(self, seconds: float) -> None:
        with self._lock:
            self._vals.append(float(seconds))

    def __len__(self) -> int:
        with self._lock:
            return len(self._vals)

    def snapshot(self) -> dict:
        """{n, mean_ms, p50_ms, p90_ms, p99_ms, max_ms} over everything
        recorded so far (empty -> {"n": 0})."""
        with self._lock:
            vals = list(self._vals)
        if not vals:
            return {"n": 0}
        ms = [v * 1e3 for v in vals]
        out = {"n": len(ms), "mean_ms": sum(ms) / len(ms),
               "max_ms": max(ms)}
        for q in (50, 90, 99):
            out[f"p{q}_ms"] = percentile(ms, q)
        return out
