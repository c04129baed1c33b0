"""`repro_torch.analysis`: the port's static analysis and run-time contract
guards (port of `repro.analysis`).

  * **static** — `python -m repro_torch.analysis.lint src/repro_torch tests
    chip_smoke.py` runs the RPR rule set (rules.py), in its torch form:
    host syncs in hot scopes, random draws without a generator, tensor
    factories without a device in hot scopes, float atomics and missing
    launch bounds in the CUDA sources, bf16 accumulation, deprecation
    warnings without a stack level, discarded spans.  Findings the port
    keeps on purpose live in `src/repro_torch/analysis/baseline.json`,
    each with its reason (shrink-only, baseline.py); anything new fails.
  * **run-time** — guards.py pins contracts no AST pass can see:
    `assert_compile_count` turns first-dispatch work on a warmed path
    (kernel builds, autotune searches) into failures, and
    `no_implicit_transfers` makes a host wait on the card raise, outside
    the sanctioned reads (`explicit_read`).

Plus docsnippets.py, the executable-docs check.  The reference's
`jit_cache_size` and `no_tracer_leaks` have no torch meaning and are not
ported.
"""
from .baseline import Baseline, load_baseline, write_baseline
from .docsnippets import Snippet, extract_snippets, run_file
from .guards import (CompileCounter, assert_compile_count, explicit_read,
                     no_implicit_transfers)
from .lint import Finding, lint_file, lint_paths
from .rules import ALL_RULES

__all__ = [
    "ALL_RULES",
    "Baseline",
    "CompileCounter",
    "Finding",
    "Snippet",
    "extract_snippets",
    "run_file",
    "assert_compile_count",
    "explicit_read",
    "lint_file",
    "lint_paths",
    "load_baseline",
    "no_implicit_transfers",
    "write_baseline",
]
