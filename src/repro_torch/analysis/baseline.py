"""The suppression baseline: an append-only-in-review, shrink-only-in-CI
contract over pre-existing lint findings.

The port's copy of `repro/analysis/baseline.py`.  The port's baseline is
`src/repro_torch/analysis/baseline.json` (the repo root's
`analysis/baseline.json` is the reference's, and stays as it is); it lists
fingerprints of findings the port keeps on purpose, each with a
per-fingerprint `count` and a human `reason`.  Semantics:

  * a finding matches iff its fingerprint appears with remaining count
    — the N+1'th identical violation in the same scope is NEW and fails;
  * `--write-baseline` drops entries that no longer fire (the ratchet);
    it refuses to add entries unless `--allow-grow` is passed, and new
    entries land with `reason: "TODO"` that review must fill in;
  * fingerprints carry no line numbers, so unrelated edits that move
    code do not churn the file.

This mirrors the artifact-header compatibility contract in
repro_torch.api.artifact: an explicit, versioned, diffable statement of
what is allowed, checked on every run.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path

from .lint import Finding

SCHEMA_VERSION = 1


@dataclasses.dataclass
class Baseline:
    """Committed suppressions keyed by line-free fingerprint."""
    entries: dict[str, dict]   # fingerprint -> {rule, path, scope, message, count, reason}

    def unmatched(self, findings: list[Finding]) -> list[Finding]:
        """Findings not covered by the baseline (respecting counts)."""
        budget = {fp: e.get("count", 1) for fp, e in self.entries.items()}
        new = []
        for f in findings:
            if budget.get(f.fingerprint, 0) > 0:
                budget[f.fingerprint] -= 1
            else:
                new.append(f)
        return new

    def stale(self, findings: list[Finding]) -> list[str]:
        """Fingerprints whose violations no longer fire (ratchet them out)."""
        live = Counter(f.fingerprint for f in findings)
        return [fp for fp in self.entries if live[fp] == 0]


def load_baseline(path: Path) -> Baseline:
    if not path.exists():
        return Baseline(entries={})
    data = json.loads(path.read_text())
    if data.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: baseline schema {data.get('schema')!r} != "
            f"{SCHEMA_VERSION} (regenerate with --write-baseline)")
    return Baseline(entries={e["fingerprint"]: e for e in data["entries"]})


def write_baseline(path: Path, findings: list[Finding],
                   previous: Baseline,
                   allow_grow: bool = False) -> tuple[int, int]:
    """Rewrite `path` from current findings. Returns (added, removed).

    Keeps the previous entry (and its human-written `reason`) for every
    fingerprint that still fires; drops stale ones; admits new ones only
    when `allow_grow` (with reason TODO).  Counts always re-sync to the
    live violation count, except they never grow without `allow_grow`.
    `added` counts new fingerprints *encountered* — without `allow_grow`
    they are refused, and a non-zero count means the gate should fail.
    """
    live = Counter(f.fingerprint for f in findings)
    by_fp: dict[str, Finding] = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint, f)

    entries = []
    added = 0
    for fp, n in sorted(live.items()):
        prev = previous.entries.get(fp)
        if prev is None:
            added += 1
            if not allow_grow:
                continue
            f = by_fp[fp]
            entries.append({"fingerprint": fp, "rule": f.rule,
                            "path": f.path, "scope": f.scope,
                            "message": f.message, "count": n,
                            "reason": "TODO"})
        else:
            count = n if allow_grow else min(n, prev.get("count", 1))
            entries.append({**prev, "count": count})
    removed = len(previous.stale(findings))
    payload = {"schema": SCHEMA_VERSION,
               "comment": "Shrink-only lint suppressions of the port; "
                          "each entry's reason says why it stays.",
               "entries": entries}
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2) + "\n")
    return added, removed
