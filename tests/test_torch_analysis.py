"""repro_torch.analysis on the CPU: the port's lint rules against golden
fixtures, baseline add/ratchet round trips, the CLI, the port's tree
against its own baseline (the counterparts of tests/test_analysis.py:37-190),
the run-time guards' CPU behaviour (a deliberate autotune miss or kernel
build fails a compile pin; the sync-debug mode is set and restored; the
warmed dense fit, sparse epoch and server bucket pin zero first-dispatch
work), and the port's docsnippets against the reference's on the same
markdown.

The fixtures live under tests/data/lint/torch/: both packages' lint drivers
skip tests/data/, and the reference's `FIXTURES.glob("rpr*.py")` does not
descend into it.  On the card, chip_smoke.py's phase `autotune` pins the
warmed dense SD, sparse and sharded fits under `assert_compile_count` and
`no_implicit_transfers`, where there is something to catch.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import docsnippets as jdocsnippets
from repro.analysis import lint_paths as jlint_paths
from repro_torch.analysis import (ALL_RULES, Baseline, assert_compile_count,
                                  explicit_read, extract_snippets, guards,
                                  lint_file, lint_paths, load_baseline,
                                  no_implicit_transfers, run_file,
                                  write_baseline)
from repro_torch.analysis.lint import main as lint_main
from repro_torch.kernels import _build, autotune
from repro_torch.kernels.autotune import KernelConfig

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "lint" / "torch"
BASELINE = REPO / "src" / "repro_torch" / "analysis" / "baseline.json"


# -- rules vs golden fixtures ----------------------------------------------------


def _fixture(name: str) -> Path:
    (path,) = FIXTURES.glob(f"{name.lower()}.*")
    return path


def test_every_rule_has_a_fixture():
    covered = {p.stem.upper() for p in FIXTURES.glob("rpr*")
               if p.suffix in (".py", ".cu")}
    assert covered == set(ALL_RULES), (covered, set(ALL_RULES))


@pytest.mark.parametrize("name", sorted(ALL_RULES))
def test_golden_fixture(name):
    golden = json.loads((FIXTURES / "expected.json").read_text())
    path = _fixture(name)
    got = [{"rule": f.rule, "line": f.line, "scope": f.scope}
           for f in lint_file(path, root=REPO)]
    assert got == golden[path.name]
    # every reported rule is the fixture's own rule — no cross-rule noise
    assert {g["rule"] for g in got} == {name}


def test_fixture_dir_is_excluded_from_sweeps():
    """Neither package's driver lints the fixtures: they are deliberate
    violations."""
    for findings in (lint_paths([REPO / "tests"], root=REPO),
                     jlint_paths([REPO / "tests"], root=REPO)):
        assert not any(f.path.startswith("tests/data/") for f in findings)


def test_port_is_lint_clean_against_its_baseline():
    """The port's tree (src/repro_torch with its csrc/*.cu, the port's
    tests, chip_smoke.py) carries no finding outside the port's baseline,
    and every baseline entry says why it stays."""
    paths = [REPO / "src" / "repro_torch", REPO / "chip_smoke.py",
             *sorted((REPO / "tests").glob("test_torch_*.py"))]
    findings = lint_paths(paths, root=REPO)
    baseline = load_baseline(BASELINE)
    new = baseline.unmatched(findings)
    assert new == [], "\n".join(f.render() for f in new)
    for entry in baseline.entries.values():
        assert entry.get("reason") and entry["reason"] != "TODO", entry
    # the CUDA sources are read (RPR004 runs over them)
    cu = sorted((REPO / "src" / "repro_torch" / "kernels" / "csrc")
                .glob("*.cu"))
    assert cu and all(lint_file(p, root=REPO) == [] for p in cu)


# -- baseline semantics ----------------------------------------------------------

VIOLATING = """\
import warnings

def old():
    warnings.warn("old", DeprecationWarning)
"""

CLEAN = """\
import warnings

def old():
    warnings.warn("old", DeprecationWarning, stacklevel=2)
"""


def _lint_tree(tmp_path):
    return lint_paths([tmp_path / "mod.py"], root=tmp_path)


def test_baseline_roundtrip_and_ratchet(tmp_path):
    mod = tmp_path / "mod.py"
    bl_path = tmp_path / "baseline.json"
    mod.write_text(VIOLATING)
    findings = _lint_tree(tmp_path)
    assert len(findings) == 1

    # a fresh baseline refuses to grow without allow_grow: the new
    # fingerprint is counted (so the gate fails) but not admitted
    added, _ = write_baseline(bl_path, findings, Baseline(entries={}),
                              allow_grow=False)
    assert added == 1 and load_baseline(bl_path).entries == {}

    # allow_grow admits it (reason TODO for review to fill in)
    added, _ = write_baseline(bl_path, findings, Baseline(entries={}),
                              allow_grow=True)
    assert added == 1
    baseline = load_baseline(bl_path)
    assert baseline.unmatched(findings) == []
    (entry,) = baseline.entries.values()
    assert entry["reason"] == "TODO" and entry["count"] == 1

    # fixing the violation ratchets the entry out on rewrite
    mod.write_text(CLEAN)
    _, removed = write_baseline(bl_path, _lint_tree(tmp_path), baseline,
                                allow_grow=False)
    assert removed == 1 and load_baseline(bl_path).entries == {}

    # reintroducing it now fails the gate again
    mod.write_text(VIOLATING)
    assert len(load_baseline(bl_path).unmatched(_lint_tree(tmp_path))) == 1


def test_baseline_count_budget(tmp_path):
    """The N+1'th identical violation in a scope is NEW even when N are
    baselined."""
    mod = tmp_path / "mod.py"
    mod.write_text(VIOLATING)
    findings = _lint_tree(tmp_path)
    bl_path = tmp_path / "baseline.json"
    write_baseline(bl_path, findings, Baseline(entries={}), allow_grow=True)
    baseline = load_baseline(bl_path)

    mod.write_text(VIOLATING.replace(
        'warnings.warn("old", DeprecationWarning)',
        'warnings.warn("old", DeprecationWarning)\n'
        '    warnings.warn("old", DeprecationWarning)'))
    doubled = _lint_tree(tmp_path)
    assert len(doubled) == 2
    assert len(baseline.unmatched(doubled)) == 1


def test_baseline_fingerprints_survive_line_drift(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(VIOLATING)
    bl_path = tmp_path / "baseline.json"
    write_baseline(bl_path, _lint_tree(tmp_path), Baseline(entries={}),
                   allow_grow=True)
    mod.write_text("# a comment pushing everything down\n\n" + VIOLATING)
    assert load_baseline(bl_path).unmatched(_lint_tree(tmp_path)) == []


def test_cli_end_to_end(tmp_path, monkeypatch, capsys):
    (tmp_path / "pkg").mkdir()
    mod = tmp_path / "pkg" / "mod.py"
    mod.write_text(VIOLATING)
    (tmp_path / "pkg" / "k.cu").write_text(
        "__global__ void k(float* p) { atomicAdd(p, 1.0f); }\n")
    monkeypatch.chdir(tmp_path)

    assert lint_main(["pkg"]) == 1                      # no baseline yet
    assert lint_main(["pkg", "--write-baseline"]) == 1  # refuses to grow
    assert lint_main(["pkg", "--write-baseline", "--allow-grow"]) == 0
    assert lint_main(["pkg"]) == 0                      # gate green
    capsys.readouterr()
    assert lint_main(["pkg", "--no-baseline", "--json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert sorted(f["rule"] for f in out) == ["RPR004", "RPR004", "RPR006"]

    mod.write_text(CLEAN)
    (tmp_path / "pkg" / "k.cu").write_text(
        "__global__ void __launch_bounds__(256) k(int* p) "
        "{ atomicAdd(p, 1); }\n")
    assert lint_main(["pkg", "--write-baseline"]) == 0  # ratchet shrink
    entries = json.loads((tmp_path / "src" / "repro_torch" / "analysis"
                          / "baseline.json").read_text())["entries"]
    assert entries == []


# -- compile-count pins ----------------------------------------------------------


@pytest.fixture
def fresh_autotune(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def test_deliberate_autotune_miss_fails_the_guard(fresh_autotune):
    """The acceptance fixture: a first dispatch inside a pinned block (an
    autotune search of a new key) MUST trip the pin; a cache hit does
    not."""
    cands = [KernelConfig(block_rows=8), KernelConfig(block_rows=16)]

    def runner(cfg, bucket_n):
        return lambda: torch.zeros(())

    autotune.get_config("ell", n=64, k=4, d=2, candidates=cands,
                        runner=runner)
    with assert_compile_count(expected=0, label="warmed") as counter:
        autotune.get_config("ell", n=64, k=4, d=2, candidates=cands,
                            runner=runner)
    assert counter.count == 0
    with pytest.raises(AssertionError, match="compile-count contract"):
        with assert_compile_count(expected=0, label="new bucket"):
            autotune.get_config("ell", n=4096, k=4, d=2, candidates=cands,
                                runner=runner)
    with assert_compile_count(at_most=1, label="one search"):
        autotune.get_config("ell", n=4096, k=8, d=2, candidates=cands,
                            runner=runner)
    with pytest.raises(ValueError, match="exactly one"):
        with assert_compile_count():
            pass


def test_kernel_build_counts_as_first_dispatch(monkeypatch, tmp_path):
    """A kernel-library build (`_build._build_all`) inside a pinned block
    trips the pin, as the reference's XLA compile does."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_sources", lambda: [])
    with pytest.raises(AssertionError, match="observed 1"):
        with assert_compile_count(expected=0):
            _build._build_all()


class _FakeSyncMode:
    """torch.cuda's sync-debug mode as a recorded value (this container's
    torch has no CUDA)."""

    def __init__(self):
        self.mode = 0
        self.history = []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
        self.history.append(self.mode)


def test_no_implicit_transfers_sets_and_restores_the_mode(monkeypatch):
    fake = _FakeSyncMode()
    monkeypatch.setattr(guards, "_cuda_in_use", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    with no_implicit_transfers():
        assert fake.mode == 2
        with explicit_read():          # the sanctioned read: mode off ...
            assert fake.mode == 0
        assert fake.mode == 2          # ... and back
    assert fake.mode == 0
    # restored on an exception too, and a warn-mode guard nests inside
    fake.mode = 1
    with pytest.raises(RuntimeError):
        with no_implicit_transfers():
            with no_implicit_transfers(mode="warn"):
                assert fake.mode == 1
            assert fake.mode == 2
            raise RuntimeError("inside")
    assert fake.mode == 1 and guards._guard_mode is None
    # outside a guard the read scope touches nothing
    n = len(fake.history)
    with explicit_read():
        pass
    assert len(fake.history) == n
    with pytest.raises(ValueError, match="mode"):
        with no_implicit_transfers(mode="off"):
            pass


def test_no_implicit_transfers_without_cuda_is_a_no_op():
    """On CPU tensors there is nothing to catch: host reads just run."""
    x = torch.arange(4.0)
    with no_implicit_transfers():
        assert float(x.sum()) == 6.0
        with explicit_read():
            assert x.tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return rng.normal(size=(96, 10)).astype(np.float32)


def test_compile_pin_dense_fit(data, fresh_autotune):
    """A second dense SD fit with the same spec and shapes does no
    first-dispatch work (on the CPU the plain path searches nothing)."""
    from repro_torch.api import Embedding, EmbedSpec
    spec = EmbedSpec(kind="ee", lam=10.0, strategy="sd", backend="dense",
                     perplexity=8.0, max_iters=3, tol=0.0, seed=0)
    Embedding(spec, device="cpu").fit(data)
    with assert_compile_count(expected=0, label="dense fit"), \
            no_implicit_transfers():
        Embedding(spec, device="cpu").fit(data)


def test_compile_pin_sparse_epoch(data, fresh_autotune):
    from repro_torch.api import EmbedSpec
    from repro_torch.embed.engine import LoopConfig, fit_loop
    from repro_torch.embed.trainer import build_sparse_objective
    spec = EmbedSpec(kind="ee", lam=50.0, perplexity=8.0, backend="sparse",
                     n_neighbors=12, n_negatives=8, max_iters=2, tol=0.0)
    obj, X0, _ = build_sparse_objective(spec, data, device="cpu")
    fit_loop(obj, X0, LoopConfig(max_iters=1, tol=0.0))        # warm-up
    with assert_compile_count(expected=0, label="sparse epoch"), \
            no_implicit_transfers():
        res = fit_loop(obj, X0, LoopConfig(max_iters=2, tol=0.0))
    assert np.all(np.isfinite(res.energies))


def test_compile_pin_server_bucket(data, fresh_autotune):
    from repro_torch.api import Embedding, EmbedSpec, TransformSpec
    from repro_torch.serve import EmbeddingServer
    emb = Embedding(EmbedSpec(kind="ee", lam=10.0, backend="dense",
                              perplexity=8.0, max_iters=3),
                    device="cpu").fit(data)
    tspec = TransformSpec(solver="rowwise", exhaustive=True, max_iters=3)
    with EmbeddingServer(emb, tspec, max_batch=4) as srv:
        srv.warmup()
        with assert_compile_count(expected=0, label="server buckets"):
            srv.transform(data[0], timeout=120.0)
            srv.transform(data[:3] + 0.01, timeout=120.0)


# -- docsnippets -----------------------------------------------------------------

DOC = """\
# A doc

```python
x = 1
```

Prose, then an indented fence in a list:

- item

  ```python
  y = x + 1
  ```

```bash
echo not python
```

```py
raise ValueError("rot")
```

```python
z = y * 2
```
"""


def test_extract_snippets_match_the_reference(tmp_path):
    path = tmp_path / "doc.md"
    path.write_text(DOC)
    got = extract_snippets(path)
    want = jdocsnippets.extract_snippets(path)
    assert [(s.path, s.lineno, s.code, s.label) for s in got] == [
        (s.path, s.lineno, s.code, s.label) for s in want]
    assert [s.lineno for s in got] == [3, 11, 19, 23]
    fails = run_file(path)
    jfails = jdocsnippets.run_file(path)
    assert [s.label for s, _ in fails] == [s.label for s, _ in jfails] == [
        f"{path}:19"]
    assert "rot" in fails[0][1]
