"""CI-checked documentation examples: run every fenced ``python`` block.

    PYTHONPATH=src python -m repro_torch.analysis.docsnippets docs

The port's copy of `repro/analysis/docsnippets.py` (the same extraction
and the same failure locations, so either package can check a markdown
file).

Docs rot by accretion — an API rename lands, the prose is updated, the
code block isn't, and the first person to paste it gets a TypeError that
the test suite never saw.  The fix is the same one the rest of this
subsystem applies to hazards: make the contract executable.  Every
fenced ```python block in ``docs/*.md`` is extracted and exec'd, in
file order, with one shared namespace PER FILE (so a doc reads like a
session: later blocks may use names defined by earlier ones, exactly as
a reader would run them).  Any exception fails CI with the doc path and
the markdown line number of the offending fence.

Consequence for doc authors: ``python`` fences must be runnable,
self-contained-per-file, and CPU-cheap (they run in tier-1 CI next to
the test suite — keep N small and iteration counts tiny).  Pseudocode,
shell transcripts, and intentionally-partial fragments belong in
``text``/``bash``/``pycon`` fences, which are not executed.

`tests/test_docs.py` drives the same extractor inside pytest, so a
broken example shows up in a normal local test run, not only in the
dedicated CI step.
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import traceback

#: fence openers that mark an executable block (```python / ```py); the
#: closing fence is any line that is exactly ``` (optionally indented)
_OPENERS = ("```python", "```py")


@dataclasses.dataclass(frozen=True)
class Snippet:
    """One fenced python block: `lineno` is the 1-based markdown line of
    the opening fence (what a failure report points at)."""

    path: str
    lineno: int
    code: str

    @property
    def label(self) -> str:
        return f"{self.path}:{self.lineno}"


def extract_snippets(path: str | pathlib.Path) -> list[Snippet]:
    """All ```python blocks of one markdown file, in document order."""
    text = pathlib.Path(path).read_text()
    out: list[Snippet] = []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        stripped = lines[i].strip()
        if stripped in _OPENERS:
            indent = len(lines[i]) - len(lines[i].lstrip())
            open_ln = i + 1
            body: list[str] = []
            i += 1
            while i < len(lines) and lines[i].strip() != "```":
                # fences inside lists/quotes are indented; strip the
                # opener's indent so the block compiles at column 0
                body.append(lines[i][indent:] if
                            lines[i][:indent].isspace() or indent == 0
                            else lines[i].lstrip())
                i += 1
            out.append(Snippet(path=str(path), lineno=open_ln,
                               code="\n".join(body) + "\n"))
        i += 1
    return out


def run_file(path: str | pathlib.Path) -> list[tuple[Snippet, str]]:
    """Execute a doc's snippets in order, one shared namespace, returning
    (snippet, traceback) for each failure.  A failed block does NOT stop
    the file: later blocks still run (they may fail from the missing
    names — both reports point at real rot)."""
    ns: dict = {"__name__": f"docsnippet:{path}"}
    failures: list[tuple[Snippet, str]] = []
    for sn in extract_snippets(path):
        try:
            code = compile(sn.code, sn.label, "exec")
            exec(code, ns)  # noqa: S102 - executing our own docs is the point
        except Exception:
            failures.append((sn, traceback.format_exc()))
    return failures


def check_paths(paths) -> int:
    """Run every doc given (files, or directories globbed for *.md);
    prints a per-file summary and returns the number of failing blocks."""
    files: list[pathlib.Path] = []
    for p in map(pathlib.Path, paths):
        files.extend(sorted(p.glob("*.md")) if p.is_dir() else [p])
    n_failed = 0
    for f in files:
        n = len(extract_snippets(f))
        fails = run_file(f)
        n_failed += len(fails)
        status = "ok" if not fails else f"{len(fails)} FAILED"
        print(f"docsnippets: {f} — {n} block(s), {status}")
        for sn, tb in fails:
            print(f"\n--- {sn.label} ---\n{sn.code}\n{tb}")
    return n_failed


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        args = ["docs"]
    failed = check_paths(args)
    if failed:
        print(f"docsnippets: FAIL — {failed} block(s) raised")
        return 1
    print("docsnippets: OK — every python fence executed cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
