"""Typed per-iteration run records and the JSONL recorder.

Port of `repro/obs/record.py`, with the same schema, so that each package
reads the other's files.  One JSON object a line, `"type"` discriminated:

    {"type": "meta",  ...}                      # free-form run metadata
    {"type": "phase", "name": str, "dur_s": float}
    {"type": "iter",  "it": int, "energy": float, "grad_norm": float,
     "alpha": float, "n_evals": int, "t": float, "iter_s": float,
     "extras": {str: float}}
    {"type": "request", "rid": int, "n_rows": int, "batch": int,
     "queue_s": float, "compute_s": float, "total_s": float,
     "status": str}                             # serving-path records

`extras` carries what the objective's `diagnostics()` reports
(`pcg_iters` / `pcg_residual` of the sparse spectral solve, `z_ema` of the
normalized models' streaming partition function, the tree's grid health)
plus `mem_bytes_in_use` / `mem_peak_bytes` where the device reports them.
The schema is append-only: readers ignore unknown keys and record types.

A resumed fit APPENDS to the same JSONL file (the recorder opens it in "a"
mode), so the iteration records stay contiguous across a checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
from typing import IO, Any

import torch


def device_memory_stats(device=None) -> dict[str, float]:
    """The CUDA caching allocator's counters of `device` (None: the current
    CUDA device, if this process has started CUDA): ``mem_bytes_in_use``
    (`allocated_bytes.all.current`) and ``mem_peak_bytes``
    (`allocated_bytes.all.peak`).  A host-side read that does not
    synchronise.  ``{}`` on the CPU and on any failure: telemetry never
    fails a run over a counter."""
    try:
        if device is None:
            if not torch.cuda.is_initialized():
                return {}
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            dev = torch.device(device)
        if dev.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(dev)
    except (RuntimeError, AssertionError, ValueError, TypeError):
        return {}
    out = {}
    if "allocated_bytes.all.current" in stats:
        out["mem_bytes_in_use"] = float(stats["allocated_bytes.all.current"])
    if "allocated_bytes.all.peak" in stats:
        out["mem_peak_bytes"] = float(stats["allocated_bytes.all.peak"])
    return out


@dataclasses.dataclass
class IterationRecord:
    """One engine iteration, fully host-side (plain python scalars)."""

    it: int
    energy: float
    grad_norm: float
    alpha: float
    n_evals: int
    t: float                  # cumulative loop seconds at this iterate
    iter_s: float             # this iteration's wall-clock
    extras: dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = "iter"
        return d

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "IterationRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})


@dataclasses.dataclass
class RequestRecord:
    """One served transform request (`repro_torch.serve`): queue wait, the
    batch's compute share and end-to-end latency, host wall-clock
    seconds."""

    rid: int                  # per-server request counter
    n_rows: int               # query rows in this request
    batch: int                # micro-batch id the request rode in (-1:
                              # rejected before batching, e.g. timeout)
    queue_s: float            # submit -> batch-start wait
    compute_s: float          # the batch's transform wall-clock
    total_s: float            # submit -> response latency
    status: str = "ok"        # 'ok' | 'timeout' | 'error'

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["type"] = "request"
        return d

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "RequestRecord":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})


class RunRecorder:
    """In-memory buffer of `IterationRecord`s and an optional JSONL mirror.

    Every `record()` both appends to `.records` and (when a path was given)
    writes one line, so a crashed run still leaves every completed
    iteration in the file once it is flushed.
    """

    def __init__(self, jsonl_path: str | None = None,
                 record_memory: bool = True):
        self.jsonl_path = jsonl_path
        self.record_memory = record_memory
        self.records: list[IterationRecord] = []
        self.requests: list[RequestRecord] = []
        self.phases: list[dict[str, Any]] = []
        self.meta: dict[str, Any] = {}
        self._fh: IO[str] | None = None

    # -- writing -------------------------------------------------------------
    def _file(self) -> IO[str] | None:
        if self.jsonl_path is None:
            return None
        if self._fh is None or self._fh.closed:
            self._fh = open(self.jsonl_path, "a")
        return self._fh

    def _emit(self, obj: dict[str, Any]) -> None:
        fh = self._file()
        if fh is not None:
            fh.write(json.dumps(obj) + "\n")

    def set_meta(self, **kw: Any) -> None:
        self.meta.update(kw)
        self._emit({"type": "meta", **kw})

    def record_phase(self, name: str, dur_s: float) -> None:
        entry = {"name": name, "dur_s": float(dur_s)}
        self.phases.append(entry)
        self._emit({"type": "phase", **entry})

    def record(self, rec: IterationRecord) -> None:
        self.records.append(rec)
        self._emit(rec.to_json())

    def record_request(self, rec: RequestRecord) -> None:
        self.requests.append(rec)
        self._emit(rec.to_json())

    def flush(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()

    # -- reading -------------------------------------------------------------
    def summary(self) -> dict[str, Any]:
        """Aggregates for reports: iteration count, final energy, mean and
        total timings and the mean of every `extras` diagnostic present in
        any record (e.g. ``pcg_iters``)."""
        recs = self.records
        out: dict[str, Any] = {
            "n_iters": len(recs),
            "phases": {p["name"]: p["dur_s"] for p in self.phases},
        }
        if self.requests:
            out["n_requests"] = len(self.requests)
        if not recs:
            return out
        out["final_energy"] = recs[-1].energy
        out["total_s"] = recs[-1].t
        out["mean_iter_s"] = sum(r.iter_s for r in recs) / len(recs)
        out["total_evals"] = sum(r.n_evals for r in recs)
        keys = sorted({k for r in recs for k in r.extras})
        for k in keys:
            vals = [r.extras[k] for r in recs if k in r.extras]
            out[f"mean_{k}"] = sum(vals) / len(vals)
        return out


def _lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_jsonl(path: str) -> tuple[dict, list[dict], list[IterationRecord]]:
    """Read a recorder JSONL back: (meta, phases, iteration records).
    Unknown record types and keys are ignored (append-only schema)."""
    meta: dict[str, Any] = {}
    phases: list[dict] = []
    records: list[IterationRecord] = []
    for obj in _lines(path):
        kind = obj.get("type")
        if kind == "meta":
            meta.update({k: v for k, v in obj.items() if k != "type"})
        elif kind == "phase":
            phases.append({"name": obj["name"], "dur_s": float(obj["dur_s"])})
        elif kind == "iter":
            records.append(IterationRecord.from_json(obj))
    return meta, phases, records


def load_requests(path: str) -> list[RequestRecord]:
    """The `"request"` records of a recorder JSONL (the serving path's
    per-request latency log); other record types are skipped."""
    return [RequestRecord.from_json(obj) for obj in _lines(path)
            if obj.get("type") == "request"]
