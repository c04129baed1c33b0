"""Render or diff telemetry JSONL runs.

Port of `repro/obs/report.py`; it reads the files of either package:

    PYTHONPATH=src python -m repro_torch.obs.report runs/a/run.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report runs/a/run.jsonl \
        runs/b/run.jsonl

One file prints the run: meta, phase timings, the per-iteration table
(energy, |grad|, alpha, evaluations, iteration time, solver diagnostics)
and the summary aggregates.  Two files print both summaries side by side
with a ratio column (B / A).  `--json` prints the summary (or the diff)
machine-readably.
"""
from __future__ import annotations

import argparse
import json
import sys

from .record import RunRecorder, load_jsonl


def summarize(path: str) -> dict:
    meta, phases, records = load_jsonl(path)
    rec = RunRecorder()
    rec.meta = meta
    rec.phases = phases
    rec.records = records
    out = rec.summary()
    out["meta"] = meta
    return out


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def render_run(path: str, max_rows: int = 20) -> str:
    meta, phases, records = load_jsonl(path)
    lines = [f"run: {path}"]
    if meta:
        lines.append("meta: " + ", ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(meta.items())))
    for p in phases:
        lines.append(f"phase {p['name']:>14s}: {p['dur_s'] * 1e3:9.2f} ms")
    if records:
        extra_keys = sorted({k for r in records for k in r.extras})
        head = (["it", "energy", "|grad|", "alpha", "evals", "iter_ms"]
                + extra_keys)
        lines.append(" ".join(f"{h:>12s}" for h in head))
        rows = records if len(records) <= max_rows else (
            records[:max_rows // 2] + records[-max_rows // 2:])
        shown = set()
        for r in rows:
            if r.it in shown:
                continue
            shown.add(r.it)
            vals = [r.it, r.energy, r.grad_norm, r.alpha, r.n_evals,
                    r.iter_s * 1e3] + [r.extras.get(k, "") for k in extra_keys]
            lines.append(" ".join(f"{_fmt(v):>12s}" for v in vals))
        if len(records) > max_rows:
            lines.append(f"... ({len(records)} iterations total)")
    s = summarize(path)
    lines.append("summary: " + ", ".join(
        f"{k}={_fmt(v)}" for k, v in sorted(s.items())
        if k not in ("meta", "phases")))
    return "\n".join(lines)


def _row(name: str, a, b, ratio: str) -> str:
    return (f"{name:>20s} {_fmt(a) if a is not None else '-':>14s} "
            f"{_fmt(b) if b is not None else '-':>14s} {ratio:>8s}")


def render_diff(path_a: str, path_b: str) -> str:
    sa, sb = summarize(path_a), summarize(path_b)
    keys = sorted((set(sa) | set(sb)) - {"meta", "phases"})
    lines = [f"diff: A={path_a}  B={path_b}",
             f"{'metric':>20s} {'A':>14s} {'B':>14s} {'B/A':>8s}"]
    for k in keys:
        a, b = sa.get(k), sb.get(k)
        ratio = (f"{b / a:.3f}"
                 if isinstance(a, (int, float)) and isinstance(b, (int, float))
                 and a != 0 else "-")
        lines.append(_row(k, a, b, ratio))
    pa, pb = sa["phases"], sb["phases"]
    for name in sorted(set(pa) | set(pb)):
        a, b = pa.get(name), pb.get(name)
        ratio = f"{b / a:.3f}" if a and b else "-"
        lines.append(_row("phase:" + name, a, b, ratio))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render one telemetry JSONL run or diff two")
    ap.add_argument("runs", nargs="+", help="1 or 2 run.jsonl paths")
    ap.add_argument("--json", action="store_true",
                    help="print the summary/diff as JSON instead of a table")
    ap.add_argument("--max-rows", type=int, default=20)
    a = ap.parse_args(argv)
    if len(a.runs) not in (1, 2):
        ap.error("expected 1 or 2 run files")
    if a.json:
        out = (summarize(a.runs[0]) if len(a.runs) == 1 else
               {"a": summarize(a.runs[0]), "b": summarize(a.runs[1])})
        print(json.dumps(out))
    elif len(a.runs) == 1:
        print(render_run(a.runs[0], max_rows=a.max_rows))
    else:
        print(render_diff(a.runs[0], a.runs[1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
