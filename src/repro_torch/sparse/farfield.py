"""Deterministic Barnes-Hut far-field repulsion on a fixed-depth grid.

Port of `repro/sparse/farfield.py`.  A fixed-depth quadtree, realized as a
pyramid of 2^l x 2^l grids over a square bounding box, whose cell centres
of mass stand in for far-away points.  The grid is built without scatters:
one stable sort of the finest-level cell ids, `searchsorted` for cell
extents, a cumulative sum for cell sums and 2x2 reshape-pooling for the
coarser levels.  No random draw, no EMA, no float atomics: repeated runs
are bit-identical.  The grid build is plain PyTorch; the cell interaction
runs csrc/farfield.cu on CUDA.

The build is split in two.  `_grid_state` computes what every evaluation
needs and no more (the sorted order, cell extents, per-level occupancy and
centre-of-mass tables, residual tables: `kernels.ref.TreeGrid`).  Each
evaluation with theta > 0 is one call of `kernels.ops.bh_tree` on that
state: on CUDA one launch that derives every interaction slot in registers
and sums the whole evaluation.  `_expand` materialises the slots as (N, W)
index and weight batches, the TPU kernel's contract, by an independent
derivation; `tree_diagnostics` reads them, and `_tree_repulsion_batched`
runs them through `kernels.ops.bh_interaction`, one call a chunk, as the
yardstick of the fused launch (both sum in the same order, so on CUDA they
give the same bits).  theta = 0 runs its one exhaustive batch that way.

Opening criterion and exactness of the partition
------------------------------------------------

With theta in (0, 1] let ``r = max(1, ceil(1/theta))``.  A target cell at
grid level l is FAR from point n's cell iff their Chebyshev cell distance
d_l exceeds r, so ``h_l / dist <= 1/r <= theta``.  Each ordered pair (n, m)
is handled exactly once:

  * levels run l1..D with ``l1 = floor(log2(r+1)) + 1``, where the "parent
    was near" condition below holds for every pair;
  * at level l the pair is accepted iff d_l > r (far now) AND the
    parent-cell distance d_{l-1} <= r (near one level up);
  * pairs with d_D <= r land in the NEAR field: exact point-to-point terms
    over the (2r+1)^2 offset window, with the self pair masked.

The far-field window holds the offsets of Chebyshev norm in (r, 2r+1]:
(4r+3)^2 - (2r+1)^2 slots (96 at the default theta = 0.5, r = 2), an
(N, 96) interaction batch per level.  Near-field cells are scanned through
`cap` listed slots taken from the sorted order; cells holding more than
`cap` points spill the excess into one residual centre-of-mass entry per
cell (weight ``count - cap``), so the partition function stays a sum over
all pairs.  theta = 0 selects the exhaustive mode: every ordered pair via
the cyclic index matrix (N, N-1), O(N^2) memory, for tests.

`tree_diagnostics` reports the partition invariant (total interaction
weight == n(n-1) exactly), mean cells visited, the worst realized opening
ratio and the residual spill mass.

Matching the reference: the cell coordinates are computed in float32 in the
reference's order, so a point on a cell boundary lands in the same cell,
and the index and weight streams equal the reference's exactly.  The
centre-of-mass tables are differences of a float32 cumulative sum, whose
rounding depends on the library's scan order; they agree with the
reference's to that rounding only.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeGrid
from repro_torch.obs import span

# -- plan ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static shape parameters of the far-field decomposition."""

    n: int          # number of points
    theta: float    # opening parameter (0 = exhaustive)
    r: int          # far-field Chebyshev radius in cells (0 = exhaustive)
    l1: int         # coarsest far-field level
    depth: int      # finest level D (grid is 2^D per side)
    cap: int        # listed near-field slots per cell
    chunk: int = 128  # max interaction-batch width per kernel call

    @property
    def exhaustive(self) -> bool:
        return self.r == 0


def make_grid_plan(n: int, *, theta: float = 0.5, depth: int = 0,
                   cap: int = 0, chunk: int = 128) -> GridPlan:
    """Resolve the static decomposition for n points at opening theta.

    `depth`/`cap` of 0 mean auto: depth targets ~4 points per finest cell
    (D = ceil(log4(n/4)), floored at l1), cap is 4x the resulting mean
    occupancy (floored at 16) so residual spill is rare."""
    if n < 2:
        raise ValueError(f"need at least 2 points, got n={n}")
    if not 0.0 <= theta <= 1.0:
        raise ValueError(f"theta must be in [0, 1], got {theta}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if theta == 0.0:
        return GridPlan(n=n, theta=0.0, r=0, l1=0, depth=0, cap=0,
                        chunk=chunk)
    r = max(1, math.ceil(1.0 / theta))
    l1 = int(math.floor(math.log2(r + 1))) + 1
    if depth == 0:
        depth = max(l1, math.ceil(0.5 * math.log2(max(n, 16) / 4)))
    if depth < l1:
        raise ValueError(
            f"tree_depth={depth} is coarser than the minimum far level "
            f"l1={l1} for theta={theta} (r={r})")
    if cap == 0:
        cap = max(16, 4 * math.ceil(n / 4 ** depth))
    if cap < 1:
        raise ValueError(f"tree_cap must be positive, got {cap}")
    return GridPlan(n=n, theta=float(theta), r=r, l1=l1, depth=int(depth),
                    cap=int(cap), chunk=int(chunk))


def _far_offsets(r: int) -> np.ndarray:
    """Static (W, 2) offset window for the far field: Chebyshev norm in
    (r, 2r+1]."""
    span_ = np.arange(-(2 * r + 1), 2 * r + 2)
    dx, dy = np.meshgrid(span_, span_, indexing="ij")
    cheb = np.maximum(np.abs(dx), np.abs(dy))
    keep = cheb > r
    return np.stack([dx[keep], dy[keep]], axis=-1).astype(np.int32)


def _near_offsets(r: int) -> np.ndarray:
    """Static ((2r+1)^2, 2) window of near cells: Chebyshev norm <= r."""
    span_ = np.arange(-r, r + 1)
    dx, dy = np.meshgrid(span_, span_, indexing="ij")
    return np.stack([dx.ravel(), dy.ravel()], axis=-1).astype(np.int32)


# -- grid build (scatter-free) -------------------------------------------------


def _grid_coords(X: torch.Tensor, depth: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Finest-level integer cell coords on a SQUARE bounding box, and the
    finest cell width h.  Coarser coords are integer shifts of these
    (`c >> (D-l)`), which makes level nesting exact regardless of float
    rounding.  Every step is float32, in the reference's order."""
    G = 1 << depth
    lo = torch.amin(X, dim=0)
    extent = torch.amax(torch.amax(X, dim=0) - lo) * (1.0 + 1e-6) + 1e-30
    h = extent / G
    c = torch.clamp(torch.floor((X - lo) / h).to(torch.int32), 0, G - 1)
    return c, h


def _finest_aggregates(coords: torch.Tensor, X: torch.Tensor, G: int):
    """Per-cell occupancy, coordinate sums and sorted-order extents at the
    finest level, scatter-free: stable sort by cell id, then searchsorted
    extents and a cumulative-sum difference.

    Returns (cs (N,) sorted cell ids, perm (N,), Xs = X[perm], starts (G^2,),
    counts (G^2,), sums (G^2, d), csum (N+1, d) cumulative sums in sorted
    order)."""
    cid = coords[:, 0] * G + coords[:, 1]
    perm = torch.argsort(cid, stable=True)
    cs = cid[perm]
    ids = torch.arange(G * G, dtype=cid.dtype, device=cid.device)
    starts = torch.searchsorted(cs, ids, side="left")
    ends = torch.searchsorted(cs, ids, side="right")
    counts = ends - starts
    Xs = X[perm]
    csum = torch.cat([X.new_zeros((1, X.shape[1])), torch.cumsum(Xs, dim=0)])
    sums = csum[ends] - csum[starts]
    return cs, perm, Xs, starts, counts, sums, csum


def _pool(counts: torch.Tensor, sums: torch.Tensor, G: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """One 2x2 aggregation step: level-l cell stats from level l+1."""
    H = G // 2
    c = counts.reshape(H, 2, H, 2).sum(dim=(1, 3))
    s = sums.reshape(H, 2, H, 2, -1).sum(dim=(1, 3))
    return c.reshape(H * H), s.reshape(H * H, -1)


def _grid_state(X: torch.Tensor, plan: GridPlan) -> TreeGrid:
    """Everything an evaluation derives its interaction slots from, and no
    (N, W) tensor: the sorted order, the finest cells' extents, every far
    level's occupancy and centre-of-mass table, and the residual tables of
    the cells that spill past `cap` (`kernels.ref.TreeGrid`)."""
    if plan.exhaustive:
        raise ValueError("theta = 0 (exhaustive mode) builds no grid")
    # the span times the host's issue: nothing here synchronises
    with span("grid-build", phase=True, n=plan.n, depth=plan.depth,
              r=plan.r, cap=plan.cap, exhaustive=plan.exhaustive):
        D, cap = plan.depth, plan.cap
        G = 1 << D
        coords, h = _grid_coords(X, D)
        cs, perm, Xs, starts, counts, sums, csum = _finest_aggregates(
            coords.long(), X, G)

        # per-level stats, finest -> coarsest (index by level l)
        counts_l = {D: counts}
        sums_l = {D: sums}
        for lev in range(D - 1, plan.l1 - 1, -1):
            counts_l[lev], sums_l[lev] = _pool(
                counts_l[lev + 1], sums_l[lev + 1], 1 << (lev + 1))
        levels = range(plan.l1, D + 1)

        # residual: cells spilling past `cap` keep one centre-of-mass entry
        # of their unlisted suffix
        listed_n = torch.clamp_max(counts, cap)
        listed_sum = csum[starts + listed_n] - csum[starts]
        res_cnt = counts - listed_n
        res_com = (sums - listed_sum) / torch.clamp_min(res_cnt, 1)[:, None]
        return TreeGrid(
            Xs=Xs, perm=perm, cids=cs, starts=starts, counts=counts,
            level_counts=tuple(counts_l[lev] for lev in levels),
            level_com=tuple(
                sums_l[lev] / torch.clamp_min(counts_l[lev], 1)[:, None]
                for lev in levels),
            res_cnt=res_cnt, res_com=res_com,
            far_offsets=torch.as_tensor(_far_offsets(plan.r),
                                        dtype=torch.int64, device=X.device),
            near_offsets=torch.as_tensor(_near_offsets(plan.r),
                                         dtype=torch.int64, device=X.device),
            h=h, r=plan.r, l1=plan.l1, depth=D, cap=cap, chunk=plan.chunk)


# -- interaction batches -------------------------------------------------------


@dataclasses.dataclass
class _Batch:
    """One ELL-shaped interaction batch: row n meets `w[n, j]` copies of
    `table[idx[n, j]]`.  `h_cell` is the cell width of the level the targets
    aggregate (0 for exact point targets); diagnostics use it for the
    realized opening ratio."""

    idx: torch.Tensor            # (N, W) int32
    w: torch.Tensor              # (N, W) f32
    table: torch.Tensor          # (M, d)
    h_cell: torch.Tensor | float
    tag: str


def _expand(X: torch.Tensor, grid: TreeGrid) -> list[_Batch]:
    """The interaction batches of a grid state, rows in X's order, by whole
    (N, W) gathers: a near slot's partner is `perm[pos]`, masked when it is
    the row's own point id, and the own-cell residual drops self by the
    row's rank in its cell from an argsort.  This derivation is independent
    of `kernels.ref.tree_slots`, the per-sorted-position arithmetic of the
    fused kernel, which the tests hold to it."""
    n = X.shape[0]
    D, r, cap = grid.depth, grid.r, grid.cap
    G = 1 << D
    dev = X.device
    inv_perm = torch.argsort(grid.perm)
    cid = grid.cids[inv_perm]                                  # (N,) X order
    coords = torch.stack([cid >> D, cid & (G - 1)], dim=1)
    batches: list[_Batch] = []

    # far field: one (N, |offsets|) batch per level against that level's
    # centre-of-mass table
    offs = grid.far_offsets
    for lev, cnt, com in zip(range(grid.l1, D + 1), grid.level_counts,
                             grid.level_com):
        Gl = 1 << lev
        cl = coords >> (D - lev)                               # (N, 2)
        tx = cl[:, 0:1] + offs[None, :, 0]                     # (N, Wf)
        ty = cl[:, 1:2] + offs[None, :, 1]
        inb = (tx >= 0) & (tx < Gl) & (ty >= 0) & (ty < Gl)
        # parent-was-near: Chebyshev distance of the parent cells <= r (the
        # arithmetic shift keeps it exact for negative offsets)
        pd = torch.maximum(torch.abs((tx >> 1) - (cl[:, 0:1] >> 1)),
                           torch.abs((ty >> 1) - (cl[:, 1:2] >> 1)))
        accept = inb & (pd <= r)
        tcell = (torch.clamp(tx, 0, Gl - 1) * Gl
                 + torch.clamp(ty, 0, Gl - 1))
        w = torch.where(accept, cnt[tcell], 0).to(torch.float32)
        batches.append(_Batch(idx=tcell.to(torch.int32), w=w, table=com,
                              h_cell=grid.h * (1 << (D - lev)),
                              tag=f"far-l{lev}"))

    # near field: exact listed pairs over the (2r+1)^2 window at the finest
    # level, `cap` sorted-order slots per cell, self masked
    noffs = grid.near_offsets
    tx = coords[:, 0:1] + noffs[None, :, 0]                    # (N, Wn)
    ty = coords[:, 1:2] + noffs[None, :, 1]
    inb = (tx >= 0) & (tx < G) & (ty >= 0) & (ty < G)
    tcell = torch.clamp(tx, 0, G - 1) * G + torch.clamp(ty, 0, G - 1)
    tcount = torch.where(inb, grid.counts[tcell], 0)           # (N, Wn)
    slot = torch.arange(cap, dtype=torch.int64, device=dev)    # (cap,)
    pos = grid.starts[tcell][:, :, None] + slot[None, None, :]  # (N, Wn, cap)
    listed = slot[None, None, :] < tcount[:, :, None]
    partner = grid.perm[torch.clamp(pos, 0, n - 1)]            # (N, Wn, cap)
    self_idx = torch.arange(n, dtype=partner.dtype, device=dev)[:, None, None]
    w_listed = (listed & (partner != self_idx)).to(torch.float32)
    Wn = noffs.shape[0]
    batches.append(_Batch(idx=partner.reshape(n, Wn * cap).to(torch.int32),
                          w=w_listed.reshape(n, Wn * cap), table=X,
                          h_cell=0.0, tag="near"))

    # residual: cells spilling past `cap` contribute one COM entry of the
    # unlisted suffix; the own-cell entry drops self when self is in the
    # suffix (rank >= cap)
    rank = inv_perm - grid.starts[cid]                         # (N,)
    own = (noffs[:, 0] == 0) & (noffs[:, 1] == 0)              # (Wn,)
    self_spill = (rank >= cap)[:, None] & own[None, :]
    w_res = torch.where(inb, grid.res_cnt[tcell], 0) - self_spill.long()
    batches.append(_Batch(idx=tcell.to(torch.int32),
                          w=torch.clamp_min(w_res, 0).to(torch.float32),
                          table=grid.res_com, h_cell=grid.h, tag="residual"))
    return batches


def _interaction_batches(X: torch.Tensor, plan: GridPlan) -> list[_Batch]:
    """Decompose all N(N-1) ordered pairs into interaction batches: far
    levels l1..D (N, Wf) against each level's centre-of-mass table, the near
    batch (N, Wn cap) against X and the residual (N, Wn); or, at theta = 0,
    the one exhaustive batch.

    The weights over all batches sum to exactly n(n-1), the partition
    invariant `tree_diagnostics` reports as `tree_pairs`."""
    n = X.shape[0]
    if plan.exhaustive:
        dev = X.device
        rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
        J = (rows + torch.arange(1, n, dtype=torch.int32, device=dev)[None, :]
             ) % n
        return [_Batch(idx=J, w=torch.ones((n, n - 1), dtype=torch.float32,
                                           device=dev),
                       table=X, h_cell=0.0, tag="exhaustive")]
    return _expand(X, _grid_state(X, plan))


# -- repulsion + diagnostics ---------------------------------------------------


def _apply_chunked(X: torch.Tensor, batch: _Batch, kind: str, chunk: int,
                   kernel_args: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Run one batch through the cell-interaction kernel in <= chunk-wide
    column slices (views, no copies), summed in the reference's order.  The
    slices exist for the TPU's VMEM budget; the port keeps them so that its
    sums round as the reference's do."""
    s = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    F = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    width = batch.idx.shape[1]
    for c0 in range(0, width, chunk):
        sl = slice(c0, min(c0 + chunk, width))
        si, Fi = ops.bh_interaction(X, batch.idx[:, sl], batch.w[:, sl],
                                    batch.table, kind, **kernel_args)
        s = s + si
        F = F + Fi
    return s, F


def _tree_repulsion_batched(X: torch.Tensor, plan: GridPlan, kind: str,
                            **kernel_args
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """`tree_repulsion` through the materialised batches, one
    `ops.bh_interaction` call a chunk: theta = 0's path, and the yardstick
    the fused kernel is held to bit for bit."""
    s = torch.zeros((), dtype=torch.float32, device=X.device)
    F = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    for b in _interaction_batches(X, plan):
        si, Fi = _apply_chunked(X, b, kind, plan.chunk, kernel_args)
        s = s + torch.sum(si)
        F = F + Fi
    return s, F


def tree_repulsion(X: torch.Tensor, plan: GridPlan, kind: str,
                   **kernel_args) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic repulsive terms from the grid decomposition: ``s`` (0-d,
    the full ordered-pair repulsive sum; for normalized kinds the partition
    function Z, exact up to cell aggregation) and ``F = L(b) X`` (N, d).
    The grid is rebuilt from X every call (X moves every iteration).
    `kernel_args` forward to `kernels.ops` (impl, storage_dtype).

    With theta > 0 one call of `ops.bh_tree` computes the whole evaluation
    from the grid state: on CUDA (impl "auto" or "kernel") one launch of the
    fused kernel, which gives the per-batch path's bits; on the CPU or
    under impl "torch" its plain version.  theta = 0 materialises the one
    exhaustive batch and runs it through `ops.bh_interaction`."""
    if X.dim() != 2 or X.shape[1] != 2:
        raise ValueError(
            f"the tree backend is 2-D only (quadtree), got d={X.shape[-1]}")
    if plan.exhaustive:
        return _tree_repulsion_batched(X, plan, kind, **kernel_args)
    s_rows, F = ops.bh_tree(_grid_state(X, plan), kind, **kernel_args)
    s = torch.zeros((), dtype=torch.float32, device=X.device)
    for s_b in s_rows:
        s = s + torch.sum(s_b)
    return s, F


def energy_and_grad_tree(X: torch.Tensor, saff, lam, kind: str,
                         plan: GridPlan, *, with_grad: bool = True,
                         **kernel_args
                         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Deterministic O(N log N) energy and gradient: exact attractive terms
    over the calibrated ELL graph (shared with energy_and_grad_sparse) plus
    grid far-field repulsion.  No random draw and no EMA: the partition
    function of the normalized kinds is the tree sum itself, and the 1/Z
    gradient factor uses it directly.  `kernel_args` forward to
    `tree_repulsion`; the gradient's ELL products take their `impl` (in
    float32 storage, as the sparse objective's)."""
    from repro_torch.core.objectives import (is_normalized,
                                             sparse_attractive_lap,
                                             sparse_attractive_terms)
    e_plus, aw = sparse_attractive_terms(X, saff, kind)
    s, F = tree_repulsion(X, plan, kind, **kernel_args)
    normalized = is_normalized(kind)
    E = e_plus + lam * (torch.log(s) if normalized else s)
    if not with_grad:
        return E, None
    la_x = sparse_attractive_lap(X, saff, kind, aw,
                                 kernel_args.get("impl", "auto"))
    lam_rep = (lam / s) if normalized else lam
    G = 4.0 * (la_x - lam_rep * F)
    return E, G


def tree_diagnostics(X: torch.Tensor, plan: GridPlan
                     ) -> dict[str, torch.Tensor]:
    """Decomposition health, from the same batches the repulsion uses, as
    0-d float32 tensors:

    - ``tree_pairs``: total interaction weight, EXACTLY n(n-1) when the
      partition is correct (a float32 sum: exact below ~2^24 pairs, n ~ 4k);
    - ``tree_cells``: mean far-field cells accepted per point;
    - ``tree_theta_ratio``: worst realized opening ratio h_cell/dist over
      accepted far-field interactions (<= theta by construction);
    - ``tree_overflow``: total residual (past-cap) interaction weight.
    """
    batches = _interaction_batches(X, plan)
    z = torch.zeros((), dtype=torch.float32, device=X.device)
    pairs, cells, ratio, overflow = z, z, z, z
    for b in batches:
        pairs = pairs + torch.sum(b.w.to(torch.float32))
        if b.tag.startswith("far"):
            cells = cells + torch.sum(b.w > 0) / plan.n
            dist = torch.sqrt(torch.sum(
                (X[:, None, :] - b.table[b.idx]) ** 2, dim=-1))
            rat = torch.where(b.w > 0,
                              b.h_cell / torch.clamp_min(dist, 1e-30), 0.0)
            ratio = torch.maximum(ratio, torch.amax(rat))
        elif b.tag == "residual":
            overflow = overflow + torch.sum(b.w)
    return {"tree_pairs": pairs, "tree_cells": cells,
            "tree_theta_ratio": ratio, "tree_overflow": overflow}
