"""`repro_torch.obs`: run telemetry, solver diagnostics and trace export
for the fit engine, backends, kernels and server.

Port of `repro/obs`, with the same names and the same JSONL schema (each
package reads the other's files):

  * `RunRecorder`: typed per-iteration records (energy, |grad|, accepted
    step, energy evaluations, PCG iterations and residual, the streaming
    z, device memory) to memory and an optional JSONL file, plus named
    phase timings (graph-build / setup / compile) and serving requests;
  * `SpanTracer` and `span()`: contextvar-scoped host span timers with
    Chrome-trace export and an optional `torch.profiler.record_function`
    hook; every instrumentation point costs one contextvar read when no
    tracer is active;
  * `Telemetry`: the user-facing switch, `Embedding.fit(telemetry=...)`
    takes `True`, an output directory or a `Telemetry`;
  * `python -m repro_torch.obs.report run.jsonl [other.jsonl]` renders one
    run or diffs two.

Nothing here imports the engine, backends or kernels, only the reverse.
"""
from .record import (IterationRecord, RequestRecord, RunRecorder,
                     device_memory_stats, load_jsonl, load_requests)
from .spans import SpanTracer, activate, current_tracer, span
from .telemetry import Telemetry, resolve_telemetry

__all__ = [
    "IterationRecord",
    "RequestRecord",
    "RunRecorder",
    "SpanTracer",
    "Telemetry",
    "activate",
    "current_tracer",
    "device_memory_stats",
    "load_jsonl",
    "load_requests",
    "resolve_telemetry",
    "span",
]
