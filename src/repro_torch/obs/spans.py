"""Span timers with Chrome-trace-event export.

Port of `repro/obs/spans.py`.  `span(name, **args)` is the one
instrumentation primitive across the port (engine phases, graph build,
graph sharding, grid build, kernel dispatch).  It reads a contextvar: with
no active `SpanTracer` it returns a shared no-op context manager, so an
instrumentation point costs one contextvar read when telemetry is off.

Spans measure HOST wall-clock time, and CUDA runs asynchronously, so a span
adds no synchronisation of its own (telemetry must not change when the
device works) and closes wherever the caller already synchronises:

  * ``solve-iter`` is a true step time: the engine reads the device once an
    iteration (`embed.engine._host_scalars`) inside it;
  * the phase spans (``setup``, ``compile``, ``graph-build`` and its steps,
    ``spectral-init``) close after the synchronisation their blocks already
    make; ``grid-build`` (every tree evaluation) and ``cross-knn`` (every
    transform) have none, so on CUDA they time the issue of their work;
  * ``kernel/*`` spans time the issue of one launch (or the whole plain
    version on the CPU), never the kernel's run on the device.

Export is the Chrome trace-event JSON format (`{"traceEvents": [...]}`,
complete "X" events with microsecond `ts`/`dur`), loadable in Perfetto
(ui.perfetto.dev) or `chrome://tracing`.  With `profiler_annotations=True`
(the reference's `jax_annotations`) every span also enters a
`torch.profiler.record_function` of the same name, so a `torch.profiler`
capture shows the spans as user annotations beside the CUDA kernels; where
the annotation cannot start the span stays a host span, and an error raised
by the span's own block always propagates.
"""
from __future__ import annotations

import contextvars
import json
import time
from typing import Any

_ACTIVE: contextvars.ContextVar["SpanTracer | None"] = \
    contextvars.ContextVar("repro_torch_obs_tracer", default=None)


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("tracer", "name", "phase", "args", "t0", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, phase: bool,
                 args: dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.phase = phase
        self.args = args
        self._ann = None

    def __enter__(self):
        if self.tracer.profiler_annotations:
            try:
                from torch.profiler import record_function
                ann = record_function(self.name)
                ann.__enter__()
                self._ann = ann
            except RuntimeError:
                self._ann = None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self.tracer._close(self.name, self.t0, t1, self.args, self.phase)
        return False


class SpanTracer:
    """Collects spans as Chrome-trace 'X' (complete) events.

    `recorder` (a `RunRecorder`) is optional: spans entered with
    `phase=True` mirror their duration into the recorder's JSONL as a phase
    record, so the phase timings live in both artifacts from one
    instrumentation point.
    """

    def __init__(self, profiler_annotations: bool = False, recorder=None):
        self.profiler_annotations = profiler_annotations
        self.recorder = recorder
        self.events: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def span(self, name: str, *, phase: bool = False, **args: Any) -> _Span:
        return _Span(self, name, phase, args)

    def _close(self, name: str, t0: float, t1: float,
               args: dict[str, Any], phase: bool) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0 - self._t0) * 1e6,       # microseconds
            "dur": (t1 - t0) * 1e6,
            "pid": 0,
            "tid": 0,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)
        if phase and self.recorder is not None:
            self.recorder.record_phase(name, t1 - t0)

    # -- export --------------------------------------------------------------
    def to_chrome_trace(self) -> dict[str, Any]:
        return {
            "traceEvents": sorted(self.events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def current_tracer() -> SpanTracer | None:
    return _ACTIVE.get()


class _Activation:
    """Context manager installing a tracer in the current context; nesting
    the same tracer is fine (tokens restore the previous value)."""

    __slots__ = ("tracer", "_token")

    def __init__(self, tracer: SpanTracer | None):
        self.tracer = tracer

    def __enter__(self):
        self._token = _ACTIVE.set(self.tracer)
        return self.tracer

    def __exit__(self, *exc):
        _ACTIVE.reset(self._token)
        return False


def activate(tracer: SpanTracer | None) -> _Activation:
    """`with activate(tracer): ...` scopes `span()` to this tracer.
    `activate(None)` is a no-op scope (callers pass their telemetry's
    tracer straight through, active or not)."""
    return _Activation(tracer)


def span(name: str, *, phase: bool = False, **args: Any):
    """Time a block against the ambient tracer; a no-op when none is
    active.  `phase=True` also mirrors the duration into the tracer's
    recorder as a named phase record (JSONL)."""
    t = _ACTIVE.get()
    if t is None:
        return _NOOP
    return t.span(name, phase=phase, **args)
