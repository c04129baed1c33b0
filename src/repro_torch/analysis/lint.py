"""Lint driver + CLI for the port's RPR rule set (rules.py).

The port's copy of `repro/analysis/lint.py`.  Run as a module:

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch tests chip_smoke.py

Python files are parsed once and every rule runs over the tree; CUDA
sources (`*.cu` under the paths given) are read as text by the rules that
check kernel sources (`CUDA_RULES`: RPR004).

Exit status is 0 iff every finding is covered by the port's baseline
(`src/repro_torch/analysis/baseline.json`, or `--baseline PATH`).  New
findings print with rule, location, scope and message and exit 1.

Findings are fingerprinted WITHOUT line numbers (rule + path + scope +
message) so the baseline survives unrelated edits that shift lines; a
`count` per fingerprint keeps the suppression tight — adding a second
identical violation in the same scope still fails the gate.

Baseline maintenance (baseline.py):

    --write-baseline       rewrite the baseline, keeping only entries that
                           still fire (the ratchet — it can only shrink)
    --allow-grow           with --write-baseline: also admit NEW findings
                           (requires a human to then fill in `reason`)
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
from pathlib import Path

#: directories never linted: fixture snippets are deliberate violations,
#: caches are not source.
EXCLUDED_PARTS = frozenset({"__pycache__", ".git", ".ruff_cache",
                            ".pytest_cache", "build", "dist"})
#: relative path prefixes excluded (fixture snippets under tests/data are
#: expected-findings inputs, not code)
EXCLUDED_PREFIXES = ("tests/data/",)
#: file suffixes linted: Python, and CUDA sources for the kernel rules
SUFFIXES = (".py", ".cu")
#: the port's baseline, relative to the root of the checkout
DEFAULT_BASELINE = Path("src/repro_torch/analysis/baseline.json")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    path: str
    line: int
    col: int
    scope: str
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-free identity: stable across edits that only move code."""
        return f"{self.rule}|{self.path}|{self.scope}|{self.message}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def lint_file(path: Path, root: Path | None = None,
              rules: dict | None = None) -> list[Finding]:
    """Run every rule over one file; returns findings sorted by line.  A
    CUDA source runs only the rules of `rules.CUDA_RULES`, with no tree."""
    from .rules import ALL_RULES, CUDA_RULES
    rules = rules if rules is not None else ALL_RULES
    if root is not None:
        try:
            rel = str(path.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(path)
    else:
        rel = str(path)
    src = path.read_text()
    findings: list[Finding] = []
    if path.suffix == ".cu":
        for code, rule in rules.items():
            if code in CUDA_RULES:
                findings.extend(rule(None, rel, src))
    else:
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as e:
            return [Finding("RPR000", rel, e.lineno or 0, e.offset or 0,
                            "<module>", f"syntax error: {e.msg}")]
        for rule in rules.values():
            findings.extend(rule(tree, rel, src))
    return sorted(findings, key=lambda f: (f.line, f.col, f.rule))


def iter_source_files(paths: list[Path], root: Path):
    for p in paths:
        if p.is_file() and p.suffix in SUFFIXES:
            yield p
            continue
        files = sorted(f for s in SUFFIXES for f in p.rglob(f"*{s}"))
        for f in files:
            if EXCLUDED_PARTS & set(f.parts):
                continue
            try:
                rel = str(f.resolve().relative_to(root.resolve()))
            except ValueError:
                rel = str(f)
            if rel.startswith(EXCLUDED_PREFIXES):
                continue
            yield f


def lint_paths(paths: list[Path], root: Path | None = None,
               rules: dict | None = None) -> list[Finding]:
    root = root or Path.cwd()
    findings: list[Finding] = []
    for f in iter_source_files(paths, root):
        findings.extend(lint_file(f, root=root, rules=rules))
    return findings


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="PyTorch/CUDA-aware lint (RPR rules) for the port.")
    ap.add_argument("paths", nargs="+", type=Path)
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline (ratchet: shrink-only "
                         "unless --allow-grow)")
    ap.add_argument("--allow-grow", action="store_true",
                    help="with --write-baseline: admit new findings")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    args = ap.parse_args(argv)

    from .baseline import load_baseline, write_baseline

    root = Path.cwd()
    findings = lint_paths(list(args.paths), root=root)

    if args.write_baseline:
        baseline = load_baseline(args.baseline)
        added, removed = write_baseline(args.baseline, findings, baseline,
                                        allow_grow=args.allow_grow)
        print(f"baseline: {args.baseline} rewritten "
              f"(+{added} new, -{removed} stale)")
        if added and not args.allow_grow:
            print("refusing to grow the baseline without --allow-grow",
                  file=sys.stderr)
            return 1
        return 0

    if args.no_baseline:
        new = findings
    else:
        baseline = load_baseline(args.baseline)
        new = baseline.unmatched(findings)

    if args.json:
        print(json.dumps([f.to_json() for f in new], indent=2))
    else:
        for f in new:
            print(f.render())
    if new:
        n_base = len(findings) - len(new)
        print(f"\n{len(new)} new finding(s) "
              f"({n_base} baselined, {len(findings)} total)",
              file=sys.stderr)
        return 1
    if not args.json:
        print(f"clean: {len(findings)} finding(s), all baselined")
    return 0


if __name__ == "__main__":
    sys.exit(main())
