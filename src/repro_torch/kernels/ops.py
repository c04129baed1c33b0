"""Kernel dispatch: the one entry point for each hand-written kernel.

Port of `repro/kernels/ops.py`: `pairwise_terms` (csrc/pairwise.cu),
`ell_lap_matvec` and `ell_lap_matvec_local` (csrc/ell.cu), and
`bh_interaction` and `bh_tree` (csrc/farfield.cu).  The rest of the port
calls these; each decides per call:

  1. **Path**, by the `impl` knob: ``"auto"`` runs the CUDA kernel on CUDA
     tensors and the PyTorch oracle on CPU tensors; ``"kernel"`` runs the
     kernel and raises for CPU tensors; ``"torch"`` runs the oracle on any
     device (the yardstick the kernel is measured against).
  2. **Precision**: ``storage_dtype="bfloat16"`` rounds X and the weights
     through bfloat16 (as `repro`'s `_maybe_bf16` does), on both paths, so
     the kernel and the oracle see the same quantization; `bh_interaction`
     rounds X and the target table only, its slot weights stay float32
     (they carry cell occupancies), and `bh_tree` rounds X and the grid's
     centre-of-mass tables.  Accumulation is float32 and outputs
     are float32.
  3. **Layout** (`ell_lap_matvec` only): ``"vmem"`` (direct gather) or
     ``"hbm"`` (staged gather: each lane copies its slots' rows into a
     ring in shared memory with cp.async).  Both give the same bits.
     `ELL_DEFAULT_LAYOUT` is ``"vmem"``, the faster of the two on the
     H100 at every main-path shape (PERF.md).  The reference picks between
     its two layouts by the TPU's VMEM budget; that budget has no
     counterpart (on Hopper X always sits in device memory, and L2 holds
     it whole at the sizes the sparse backend runs).

The TPU layout steps of the reference (padding d to 128 lanes and N to a
tile multiple) have no counterpart either: the kernels take any d and mask
the ragged edge themselves.  Nor does the reference's ``"vmem-cap"`` branch
of `bh_interaction`, which fell back to jnp when the target table outgrew
VMEM: on Hopper the table is read from device memory through L2 whatever
its size, so every CUDA request runs the kernel.

  4. **Launch shape** (kernel path only), by the autotuner
     (`kernels/autotune.py`): an explicit `block_rows` / `block_cols` /
     `chunk` wins (an unset one takes the fixed shape); with none given the
     first call of a (kernel and, where the work depends on it, kind; shape
     bucket, k, d, storage) searches the candidates on its own tensors and
     later calls reuse the pick (a cache hit: a dict lookup).  Every candidate gives the same bits, so the
     search changes no output.  The plain path searches nothing.

The reference's sharded backend resolves its local-rows kernel once, at
build time (`resolve_local_ell`: autotuned `block_rows` rounded to a divisor
of the shard, so that the scalar-prefetched row offset moves whole
blocks), because its kernel then runs inside a `shard_map` trace, where no
search can run.  The CUDA grid has no tile that must divide the shard, and
the port's local calls run eagerly: `resolve_local_ell` checks the request
at build time and returns the keyword arguments that sparse/sharding.py
passes on, and `ell_lap_matvec_local` resolves its shape at its first
dispatch on the shard's own tensors, for the forward and the reverse graph
apart (their k differ); it takes any row offset, and its layout is
``"vmem"`` only, as in the reference.

`bh_tree` has no counterpart in the reference: it is one whole Barnes-Hut
evaluation, every slot of `bh_interaction`'s batches derived from the grid
state inside one launch (`sparse/farfield.py` calls it for every
evaluation with theta > 0; its plain version is `ref.bh_tree_ref`).

Every decision is recorded: `last_dispatch(name)` for each entry point
returns the most recent one as a dict of path, reason, storage (and, on
the kernel path, layout, the launch shape and whether it was autotuned and
came from the cache, as the reference's); under an active telemetry
recorder (`repro_torch.obs`) the same dict is merged into its ``kernel_dispatch`` meta, written again only when a
kernel's decision changes.  Each call runs under a ``kernel/<name>`` span
with the decision as its args: host time, so on CUDA the issue of one
launch (a span adds no synchronisation), on the CPU the plain version's
whole run.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.obs import current_tracer, span

from . import autotune
from .farfield import (bh_interaction_cuda, bh_launcher, launch_tree,
                       pack_tree, tree_launcher)
from .pairwise import pairwise_launcher, pairwise_terms_cuda
from .ref import (KINDS, PairwiseTerms, TreeGrid, bh_interaction_ref,
                  bh_tree_ref, ell_lap_matvec_local_ref, ell_lap_matvec_ref,
                  pairwise_terms_ref)
from .sparse_attractive import (LAYOUTS, ell_lap_matvec_cuda,
                                ell_lap_matvec_local_cuda, ell_launcher,
                                ell_local_launcher)

IMPLS = ("auto", "kernel", "torch")
#: the layout `ell_lap_matvec` runs when none is asked for
ELL_DEFAULT_LAYOUT = "vmem"
STORAGE_DTYPES = ("float32", "bfloat16")
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_LAST: dict[str, dict] = {}


def last_dispatch(kernel: str | None = None):
    """The most recent dispatch decision (dict of path/reason/storage), per
    kernel or the whole registry."""
    return dict(_LAST) if kernel is None else _LAST.get(kernel)


def _record(kernel: str, info: dict) -> None:
    """Keep the decision for `last_dispatch` and merge it into the active
    recorder's ``kernel_dispatch`` meta (a meta line only when it
    changed: the port dispatches on every call, not once a trace)."""
    _LAST[kernel] = info
    tracer = current_tracer()
    rec = tracer.recorder if tracer is not None else None
    if rec is not None:
        merged = dict(rec.meta.get("kernel_dispatch") or {})
        if merged.get(kernel) != info:
            merged[kernel] = info
            rec.set_meta(kernel_dispatch=merged)


def resolve_storage(storage_dtype: str | None) -> str:
    name = storage_dtype or "float32"
    if name not in STORAGE_DTYPES:
        raise ValueError(f"unsupported storage_dtype {storage_dtype!r}; "
                         f"have {STORAGE_DTYPES}")
    return name


def to_storage(x: torch.Tensor, storage: str) -> torch.Tensor:
    """x in the storage dtype, contiguous; no copy when it already is."""
    return x.to(_TORCH_DTYPE[storage]).contiguous()


def _path(impl: str, X: torch.Tensor) -> tuple[str, str]:
    """(path, reason) for a request: the oracle for ``impl="torch"`` and
    for CPU tensors under ``"auto"``; the kernel otherwise (which raises
    for a CPU tensor under ``"kernel"``)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    if impl == "torch":
        return "torch", "forced-off"
    if impl == "auto":
        return ("kernel", "cuda-default") if X.is_cuda else ("torch",
                                                             "cpu-tensor")
    if not X.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; X is on "
                         f"{X.device}")
    return "kernel", "forced-on"


def _tuned(kernel: str, explicit: bool, *, n: int, k: int, d: int,
           storage: str, candidates, runner
           ) -> tuple[autotune.KernelConfig | None, dict]:
    """The autotuned config of a kernel-path request, unless the caller gave
    a launch shape (`explicit`): (config or None, the record's autotuned
    and cache_hit)."""
    if explicit:
        return None, {"autotuned": False, "cache_hit": False}
    cfg, hit = autotune.get_config(kernel, n=n, k=k, d=d, dtype=storage,
                                   candidates=candidates, runner=runner)
    return cfg, {"autotuned": True, "cache_hit": hit}


def pairwise_terms(X: torch.Tensor, Wa: torch.Tensor, Wb: torch.Tensor,
                   kind: str, *, impl: str = "auto",
                   storage_dtype: str | None = None,
                   block_rows: int | None = None,
                   block_cols: int | None = None) -> PairwiseTerms:
    """Fused pairwise terms; see kernels/ref.py for the contract.  On the
    kernel path `block_rows` (rows a block) and `block_cols` (X columns
    staged a tile) set the launch shape; with neither given it is
    autotuned."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    path, reason = _path(impl, X)
    storage = resolve_storage(storage_dtype)
    info = {"path": path, "reason": reason, "storage": storage}
    if path == "torch":
        _record("pairwise_terms", info)
        with span("kernel/pairwise_terms", n=X.shape[0], kind=kind, **info):
            Xs, Was, Wbs = (to_storage(t, storage).float()
                            for t in (X, Wa, Wb))
            return pairwise_terms_ref(Xs, Was, Wbs, kind)
    Xs, Was, Wbs = (to_storage(t, storage) for t in (X, Wa, Wb))
    n, d = X.shape
    cands = autotune.pairwise_candidates(d=d)
    cfg, tuned = _tuned(
        f"pairwise.{kind}", block_rows is not None or block_cols is not None,
        n=n, k=0, d=d, storage=storage, candidates=cands,
        runner=lambda c, _: pairwise_launcher(
            Xs, Was, Wbs, kind, block_rows=c.block_rows,
            block_cols=c.block_cols)[0])
    cfg = cfg or cands[0]          # the fixed shape where the caller left it
    block_rows, block_cols = (block_rows or cfg.block_rows,
                              block_cols or cfg.block_cols)
    info.update(layout="tiled", block_rows=block_rows,
                block_cols=block_cols, **tuned)
    _record("pairwise_terms", info)
    with span("kernel/pairwise_terms", n=n, kind=kind, **info):
        return pairwise_terms_cuda(Xs, Was, Wbs, kind, block_rows=block_rows,
                                   block_cols=block_cols)


def ell_lap_matvec(X: torch.Tensor, indices: torch.Tensor,
                   weights: torch.Tensor, *, impl: str = "auto",
                   layout: str | None = None,
                   storage_dtype: str | None = None,
                   block_rows: int | None = None,
                   chunk: int | None = None) -> torch.Tensor:
    """Directed ELL Laplacian product L(A) X, float32 (N, d); see
    kernels/ref.py for the contract.  `layout` None means
    `ELL_DEFAULT_LAYOUT`.  On the kernel path `block_rows` and `chunk` set
    the launch shape (`sparse_attractive`); with neither given it is
    autotuned."""
    path, reason = _path(impl, X)
    storage = resolve_storage(storage_dtype)
    lay = layout or ELL_DEFAULT_LAYOUT
    if lay not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")
    info = {"path": path, "reason": reason, "storage": storage}
    n, k = X.shape[0], indices.shape[1]
    if path == "torch":
        _record("ell_lap_matvec", info)
        with span("kernel/ell_lap_matvec", n=n, k=k, **info):
            return ell_lap_matvec_ref(to_storage(X, storage).float(),
                                      indices,
                                      to_storage(weights, storage).float())
    Xs, ws = to_storage(X, storage), to_storage(weights, storage)
    idx = indices.to(torch.int32).contiguous()
    cands = autotune.ell_candidates(k=k, layouts=[lay])
    cfg, tuned = _tuned(
        "ell" if lay == "vmem" else "ell_hbm",
        block_rows is not None or chunk is not None, n=n, k=k, d=X.shape[1],
        storage=storage, candidates=cands,
        runner=lambda c, _: ell_launcher(
            Xs, idx, ws, layout=lay, block_rows=c.block_rows,
            chunk=c.chunk)[0])
    cfg = cfg or cands[0]          # the fixed shape where the caller left it
    block_rows, chunk = block_rows or cfg.block_rows, chunk or cfg.chunk
    info.update(layout=lay, block_rows=block_rows, chunk=chunk, **tuned)
    _record("ell_lap_matvec", info)
    with span("kernel/ell_lap_matvec", n=n, k=k, **info):
        return ell_lap_matvec_cuda(Xs, idx, ws, layout=lay,
                                   block_rows=block_rows, chunk=chunk)


def resolve_local_ell(nb: int, k: int, d: int, *, impl: str = "auto",
                      storage_dtype: str | None = None) -> dict:
    """Build-time check of the row-sharded backend's local-rows ELL requests
    (sparse/sharding.py): the keyword arguments of `ell_lap_matvec_local`
    for shards of nb rows, k slots and d columns (0: any).  Raises for an
    unknown impl or storage or an empty shard, before the fit starts; the
    path (kernel or oracle) follows each call's tensors, as in every
    dispatch here; the launch shape is autotuned at the first kernel
    dispatch (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    if nb < 1 or k < 1 or d < 0:
        raise ValueError(f"local ELL shards need nb, k >= 1 and d >= 0, got "
                         f"nb={nb}, k={k}, d={d}")
    return {"impl": impl, "storage": resolve_storage(storage_dtype)}


def ell_lap_matvec_local(X_rep: torch.Tensor, indices: torch.Tensor,
                         weights: torch.Tensor, row0: int, *,
                         impl: str = "auto", storage: str | None = None,
                         block_rows: int | None = None,
                         chunk: int | None = None) -> torch.Tensor:
    """Rows [row0, row0 + nb) of L(A) X against a replicated X_rep (n_x, d),
    float32 (nb, d); see `ref.ell_lap_matvec_local_ref` for the contract.
    `indices` (nb, k) hold global row ids.  bfloat16 `storage` rounds X_rep
    and the weights on both paths.  On the kernel path `block_rows` and
    `chunk` set the launch shape as for "vmem"; with neither given it is
    autotuned."""
    path, reason = _path(impl, X_rep)
    storage = resolve_storage(storage)
    info = {"path": path, "reason": reason, "storage": storage}
    nb, k = indices.shape[0], indices.shape[1]
    if path == "torch":
        _record("ell_lap_matvec_local", info)
        with span("kernel/ell_lap_matvec_local", nb=nb, k=k, row0=row0,
                  **info):
            return ell_lap_matvec_local_ref(
                to_storage(X_rep, storage).float(), indices,
                to_storage(weights, storage).float(), row0)
    Xs, ws = to_storage(X_rep, storage), to_storage(weights, storage)
    idx = indices.to(torch.int32).contiguous()
    cands = autotune.ell_candidates(k=k, layouts=["vmem"])
    cfg, tuned = _tuned(
        "ell_local", block_rows is not None or chunk is not None, n=nb, k=k,
        d=X_rep.shape[1], storage=storage, candidates=cands,
        runner=lambda c, _: ell_local_launcher(
            Xs, idx, ws, row0, block_rows=c.block_rows, chunk=c.chunk)[0])
    cfg = cfg or cands[0]          # the fixed shape where the caller left it
    block_rows, chunk = block_rows or cfg.block_rows, chunk or cfg.chunk
    info.update(layout="vmem", block_rows=block_rows, chunk=chunk, **tuned)
    _record("ell_lap_matvec_local", info)
    with span("kernel/ell_lap_matvec_local", nb=nb, k=k, row0=row0, **info):
        return ell_lap_matvec_local_cuda(Xs, idx, ws, row0,
                                         block_rows=block_rows, chunk=chunk)


def bh_interaction(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                   table: torch.Tensor, kind: str, *, impl: str = "auto",
                   storage_dtype: str | None = None,
                   block_rows: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Barnes-Hut cell interaction (s_n (N,), F_n (N, d)), float32; see
    kernels/ref.py for the contract.  `idx` (N, W) indexes rows of `table`
    (M, d); `w` (N, W) are the slot weights (0 = masked).  On the kernel
    path `block_rows` sets the launch shape; unset, it is autotuned."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    path, reason = _path(impl, X)
    storage = resolve_storage(storage_dtype)
    info = {"path": path, "reason": reason, "storage": storage}
    n, width, m = X.shape[0], idx.shape[1], table.shape[0]
    if path == "torch":
        _record("bh_interaction", info)
        with span("kernel/bh_interaction", n=n, w=width, m=m, kind=kind,
                  **info):
            return bh_interaction_ref(to_storage(X, storage).float(), idx,
                                      w.float(),
                                      to_storage(table, storage).float(),
                                      kind)
    Xs, tab = to_storage(X, storage), to_storage(table, storage)
    ii, ww = idx.to(torch.int32), w.to(torch.float32)
    cfg, tuned = _tuned(
        f"bh.{kind}", block_rows is not None, n=n, k=width, d=X.shape[1],
        storage=storage, candidates=autotune.bh_candidates(width=width),
        runner=lambda c, _: bh_launcher(Xs, ii, ww, tab, kind,
                                        block_rows=c.block_rows)[0])
    if cfg is not None:
        block_rows = cfg.block_rows
    info.update(layout="vmem", block_rows=block_rows, **tuned)
    _record("bh_interaction", info)
    with span("kernel/bh_interaction", n=n, w=width, m=m, kind=kind, **info):
        return bh_interaction_cuda(Xs, ii, ww, tab, kind,
                                   block_rows=block_rows)


def _tree_slots(grid: TreeGrid) -> int:
    """Slots a row of one evaluation: far levels, near and residual."""
    wf, wn = grid.far_offsets.shape[0], grid.near_offsets.shape[0]
    return wf * (grid.depth - grid.l1 + 1) + wn * (grid.cap + 1)


def bh_tree(grid: TreeGrid, kind: str, *, impl: str = "auto",
            storage_dtype: str | None = None,
            block_rows: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole Barnes-Hut evaluation from the grid state (s_rows
    (n_batches, N), F (N, d)), float32, in the original point order; see
    `ref.bh_tree_ref` for the contract.  The kernel path's s rows may be
    views of a wider buffer (each row contiguous).  On the kernel path
    `block_rows` (rows a block) sets the launch shape; unset, it is
    autotuned."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    path, reason = _path(impl, grid.Xs)
    storage = resolve_storage(storage_dtype)
    info = {"path": path, "reason": reason, "storage": storage}
    if path == "torch":
        def rounded(t):
            return to_storage(t, storage).float()
    else:
        def rounded(t):
            return to_storage(t, storage)
    grid = dataclasses.replace(
        grid, Xs=rounded(grid.Xs), res_com=rounded(grid.res_com),
        level_com=tuple(rounded(c) for c in grid.level_com))
    n = grid.Xs.shape[0]
    if path == "torch":
        _record("bh_tree", info)
        with span("kernel/bh_tree", n=n, depth=grid.depth, kind=kind,
                  **info):
            return bh_tree_ref(grid, kind)
    packed = pack_tree(grid)
    cfg, tuned = _tuned(
        f"bh_tree.{kind}", block_rows is not None, n=n, k=_tree_slots(grid),
        d=2, storage=storage, candidates=autotune.bh_tree_candidates(),
        runner=lambda c, _: tree_launcher(packed, kind,
                                          block_rows=c.block_rows)[0])
    if cfg is not None:
        block_rows = cfg.block_rows
    info.update(block_rows=block_rows, **tuned)
    _record("bh_tree", info)
    with span("kernel/bh_tree", n=n, depth=grid.depth, kind=kind, **info):
        return launch_tree(packed, kind, block_rows=block_rows)
