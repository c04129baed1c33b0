"""Run-time contract guards: invariants the AST pass cannot see.

Port of `repro/analysis/guards.py`.  Two families, usable standalone or
around a test's or a smoke run's hot loop:

  * `assert_compile_count(expected=..)` / `CompileCounter` — count the
    port's first-dispatch work inside a block and fail if the count is
    wrong.  The port compiles no program per shape as XLA does; what it
    does at first dispatch is build and load its kernel libraries
    (`kernels/_build.py`, `_build_all`) and search a launch shape
    (`kernels/autotune.py`, a `get_config` miss).  After warm-up, a dense
    SD fit, a sparse epoch, a sharded epoch and a warmed server bucket must
    count **zero** of either: the reference's four pins.

  * `no_implicit_transfers()` — `torch.cuda.set_sync_debug_mode("error")`
    for a block, the mode restored on exit: any operation that makes the
    host wait on the card (`.item()`, `.cpu()`, `bool(tensor)`, a
    synchronous upload of host data) raises.  The reads the port means to
    make go through `explicit_read()`: the engine's one batched read an
    iteration (`embed/engine.py::_host_scalars`), PCG's one flag a CG step
    (`sparse/linalg.py::pcg`, the reference's stopping rule) and the line
    search's one Armijo flag a trial (`core/linesearch.py`, the reference's
    loop condition).  On CPU tensors there is nothing to catch, and without
    CUDA the guard does nothing.

The reference's `jit_cache_size` and `no_tracer_leaks` have no torch
meaning (there is no jit cache and no tracer) and are not ported.

Warm-up protocol for the compile pins, as the reference's: run the exact
call sequence once before opening the counting context:

    fit()                                  # warm-up: builds and searches
    with assert_compile_count(expected=0):
        fit()                              # pinned: cache hits only
"""
from __future__ import annotations

import contextlib
import threading

import torch

_lock = threading.Lock()
#: the sync-debug mode a live `no_implicit_transfers` set, else None
_guard_mode: str | None = None


def _first_dispatch_work() -> int:
    from repro_torch.kernels import _build, autotune
    return _build.n_builds + autotune.n_searches


class CompileCounter:
    """Counts first-dispatch work (kernel-library builds and autotune
    searches) while registered (see `assert_compile_count` for the
    assertion wrapper).  `count` is live inside the block."""

    def __init__(self) -> None:
        self._start: int | None = None
        self._stop: int | None = None

    @property
    def count(self) -> int:
        if self._start is None:
            return 0
        now = self._stop if self._stop is not None else _first_dispatch_work()
        return now - self._start

    def __enter__(self) -> "CompileCounter":
        self._start, self._stop = _first_dispatch_work(), None
        return self

    def __exit__(self, *exc) -> None:
        self._stop = _first_dispatch_work()


@contextlib.contextmanager
def assert_compile_count(expected: int | None = None,
                         at_most: int | None = None,
                         label: str = ""):
    """Fail unless the block does exactly `expected` (or at most `at_most`)
    kernel-library builds and autotune searches.

    Yields the live CompileCounter.  Remember the warm-up protocol (module
    docstring): run the call sequence once before pinning `expected=0`.
    """
    if (expected is None) == (at_most is None):
        raise ValueError("pass exactly one of expected= / at_most=")
    tag = f" [{label}]" if label else ""
    with CompileCounter() as counter:
        yield counter
    if expected is not None and counter.count != expected:
        raise AssertionError(
            f"compile-count contract{tag}: expected exactly {expected} "
            f"kernel build(s) or autotune search(es), observed "
            f"{counter.count} — something dispatched for the first time "
            f"(a new shape bucket, dtype or kernel)")
    if at_most is not None and counter.count > at_most:
        raise AssertionError(
            f"compile-count contract{tag}: expected <= {at_most} kernel "
            f"build(s) or autotune search(es), observed {counter.count}")


def _cuda_in_use() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def no_implicit_transfers(mode: str = "error"):
    """Make every operation that waits on the card raise (`mode="error"`)
    or warn (``"warn"``, to list them all) inside the block, except those
    inside `explicit_read()`; the sync-debug mode is restored on exit.
    Explicit, asynchronous moves (pinned `non_blocking` uploads) stay
    allowed: the contract is that every host wait on a hot path is
    deliberate."""
    global _guard_mode
    if mode not in ("error", "warn"):
        raise ValueError(f"unknown mode {mode!r}; have 'error', 'warn'")
    if not _cuda_in_use():
        yield
        return
    with _lock:
        prev_guard = _guard_mode
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        _guard_mode = mode
    try:
        yield
    finally:
        with _lock:
            torch.cuda.set_sync_debug_mode(prev)
            _guard_mode = prev_guard


class explicit_read:
    """A sanctioned host read of device values: inside it, a live
    `no_implicit_transfers` lets the read wait on the card.  Outside a
    guard it costs one attribute test."""

    __slots__ = ("_mode",)

    def __enter__(self) -> None:
        self._mode = _guard_mode
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(0)

    def __exit__(self, *exc) -> None:
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
