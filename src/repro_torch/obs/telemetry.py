"""`Telemetry`: the user-facing telemetry switch and its resolution.

Port of `repro/obs/telemetry.py`:

    Embedding(spec).fit(Y, telemetry=True)            # in memory only
    Embedding(spec).fit(Y, telemetry="runs/exp1")     # JSONL + trace files
    Embedding(spec).fit(Y, telemetry=Telemetry(jsonl="r.jsonl",
                                               trace="trace.json",
                                               profiler_annotations=True))

One `Telemetry` bundles the recorder (per-iteration JSONL records) and the
span tracer (Chrome-trace export); the backends activate it around the
graph build and the fit, so every `repro_torch.obs.span` lands in one
timeline.  `finalize()` is idempotent: `Embedding.fit` calls it after the
engine returns (or raises), flushing the JSONL and writing the trace file.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

from .record import RunRecorder
from .spans import SpanTracer, activate


@dataclasses.dataclass
class Telemetry:
    """Telemetry configuration and its live recorder and tracer.

    jsonl:                per-iteration records file (appended, so that a
                          resumed fit keeps one contiguous record stream);
                          None keeps the records in memory only.
    trace:                Chrome-trace-event JSON output path; None skips
                          the export (spans still collect in memory).
    profiler_annotations: enter a `torch.profiler.record_function` for
                          every span, so a `torch.profiler` capture shows
                          the same names beside the CUDA kernels (the
                          reference's `jax_annotations`).
    record_memory:        put the fit device's memory counters in the
                          iteration records (empty on the CPU).
    """

    jsonl: str | None = None
    trace: str | None = None
    profiler_annotations: bool = False
    record_memory: bool = True

    def __post_init__(self):
        self.recorder = RunRecorder(self.jsonl,
                                    record_memory=self.record_memory)
        self.tracer = SpanTracer(
            profiler_annotations=self.profiler_annotations,
            recorder=self.recorder)

    def activate(self):
        """Scope `repro_torch.obs.span()` to this telemetry's tracer."""
        return activate(self.tracer)

    def finalize(self) -> None:
        """Flush the JSONL and write the trace file; idempotent (the trace
        is rewritten with the latest spans if called again)."""
        self.recorder.flush()
        if self.trace is not None:
            self.tracer.write_chrome_trace(self.trace)

    def summary(self) -> dict[str, Any]:
        return self.recorder.summary()


def resolve_telemetry(arg: Any) -> Telemetry | None:
    """The `Embedding.fit(telemetry=...)` argument contract:

    None / False  -> no telemetry (a contextvar read at each
                     instrumentation point, nothing else)
    True          -> in-memory recorder and tracer, no files
    str (a dir)   -> Telemetry(jsonl=<dir>/run.jsonl,
                               trace=<dir>/trace.json), dir created
    Telemetry     -> used as it is (the caller owns paths and options)
    """
    if arg is None or arg is False:
        return None
    if arg is True:
        return Telemetry()
    if isinstance(arg, (str, os.PathLike)):
        d = os.fspath(arg)
        os.makedirs(d, exist_ok=True)
        return Telemetry(jsonl=os.path.join(d, "run.jsonl"),
                         trace=os.path.join(d, "trace.json"))
    if isinstance(arg, Telemetry):
        return arg
    raise TypeError(
        f"telemetry= wants None, bool, a directory path or a Telemetry, "
        f"got {type(arg).__name__}")
