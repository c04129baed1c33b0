"""Plain PyTorch oracles of the hand-written CUDA kernels.

Port of `repro/kernels/ref.py`.  `pairwise_terms_ref` materializes the
N x N pair matrices and is the plain version beside csrc/pairwise.cu;
`ell_lap_matvec_ref` and `ell_lap_matvec_local_ref` are the plain versions
beside csrc/ell.cu, and `bh_interaction_ref` and `bh_tree_ref` the ones
beside csrc/farfield.cu's two kernels.  Each is the CPU path of its `ops`
entry point and the yardstick its kernel is held to.

Unified contract — for X (N, d), attractive weights Wa, repulsive weights
Wb (both symmetric, zero diagonal):

    kind      a_nm (attractive)    b_nm (repulsive)        e_plus            s
    'ee'      Wa                   Wb * exp(-t)            sum Wa*t          sum b
    'ssne'    Wa (=P)              Wb * exp(-t)            sum Wa*t          sum b
    'tsne'    Wa*K                 Wb*K^2  (K=1/(1+t))     sum Wa*log(1+t)   sum Wb*K
    'tee'     Wa                   Wb*K^2                  sum Wa*t          sum Wb*K
    'epan'    Wa                   Wb*[t<1]                sum Wa*t          sum Wb*max(1-t,0)

with t = ||x_n - x_m||^2.  Outputs la_x = L(a) X, lb_x = L(b) X and the
scalars e_plus and s; core/objectives.py combines them into E and grad E.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

KINDS = ("ee", "ssne", "tsne", "tee", "epan")


class PairwiseTerms(NamedTuple):
    la_x: torch.Tensor    # (N, d)
    lb_x: torch.Tensor    # (N, d)
    e_plus: torch.Tensor  # 0-d
    s: torch.Tensor       # 0-d


def _pairwise_sq_dists(X: torch.Tensor) -> torch.Tensor:
    r = torch.sum(X * X, dim=-1)
    t = r[:, None] + r[None, :] - 2.0 * (X @ X.T)
    t = torch.clamp_min(t, 0.0)
    return t.fill_diagonal_(0.0)


def _lap_matmul(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.sum(W, dim=-1)[:, None] * X - W @ X


def ell_lap_matvec_ref(X: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Directed ELL Laplacian product (the contract of csrc/ell.cu):

        (L(A) X)_n = (sum_j w_nj) x_n - sum_j w_nj x_{i_nj}

    for indices (N, k) and weights (N, k).  A padding slot (indices[n, j] =
    n, w = 0) contributes exactly zero; duplicate columns sum."""
    deg = torch.sum(weights, dim=-1, keepdim=True)
    return deg * X - torch.einsum("nk,nkd->nd", weights, X[indices])


def check_local_rows(n_x: int, nb: int, row0: int) -> None:
    """Raise unless rows [row0, row0 + nb) of an (n_x, d) X exist: the row
    range of the local-rows contract (`ell_lap_matvec_local_ref`)."""
    if not 1 <= nb <= n_x:
        raise ValueError(f"the local graph has {nb} rows; it must have 1 to "
                         f"n_x = {n_x} (the replicated X's rows)")
    if not 0 <= row0 <= n_x - nb:
        raise ValueError(f"row0 = {row0} must lie in [0, n_x - nb] = "
                         f"[0, {n_x - nb}] (n_x = {n_x}, nb = {nb})")


def ell_lap_matvec_local_ref(X_rep: torch.Tensor, indices: torch.Tensor,
                             weights: torch.Tensor, row0: int
                             ) -> torch.Tensor:
    """Rows [row0, row0 + nb) of `ell_lap_matvec_ref` (the contract of the
    local-rows kernel of csrc/ell.cu): for a replicated X_rep (n_x, d) and
    one shard's graph rows, indices (nb, k) with global column ids and
    weights (nb, k),

        out_r = (sum_j w_rj) x_{row0 + r} - sum_j w_rj x_{i_rj}."""
    nb = indices.shape[0]
    check_local_rows(X_rep.shape[0], nb, row0)
    deg = torch.sum(weights, dim=-1, keepdim=True)
    return (deg * X_rep[row0:row0 + nb]
            - torch.einsum("nk,nkd->nd", weights, X_rep[indices]))


def negative_pair_terms(kind: str, t: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pair repulsive terms (s_pair, b) at squared distances t, for all
    kinds (W- = 1 off-diagonal): s_pair sums to the repulsive term s and b
    is the pair's gradient-Laplacian weight.  The normalized kinds pair like
    the unnormalized ones: ssne like ee (Gaussian), tsne like tee
    (Student-t)."""
    if kind in ("ee", "ssne"):
        s_pair = torch.exp(-t)
        return s_pair, s_pair
    if kind in ("tee", "tsne"):
        K = 1.0 / (1.0 + t)
        return K, K * K
    if kind == "epan":
        return torch.clamp_min(1.0 - t, 0.0), (t < 1.0).to(t.dtype)
    raise ValueError(f"unknown kind {kind!r}")


def bh_interaction_ref(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                       table: torch.Tensor, kind: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Barnes-Hut cell interaction (the contract of csrc/farfield.cu).

    Row n interacts with `w[n, j]` weighted targets `table[idx[n, j]]`
    (cell centres of mass with w = occupancy, or points with w = 1):

        t_nj = ||x_n - table[idx[n, j]]||^2
        (sp, b) = negative_pair_terms(kind, t)
        s_n = sum_j w_nj * sp_nj                          (N,)
        F_n = sum_j w_nj * b_nj * (x_n - table[idx_nj])   (N, d)

    A slot with w = 0 contributes exactly zero, whatever its index.  F is
    summed over the differences, as the kernel sums it, and not as the
    reference's oracle forms it, (sum_j w b) x_n - sum_j w b c_j: that form
    loses digits when x_n is far from the origin and near its targets, and
    the SD solve of the tree fit amplifies such rounding along its near-null
    modes (ROADMAP.md, Queue 3)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    diff = X[:, None, :] - table[idx]                  # (N, W, d)
    t = torch.sum(diff * diff, dim=-1)                 # (N, W)
    sp, b = negative_pair_terms(kind, t)
    s_n = torch.sum(w * sp, dim=-1)
    F = torch.einsum("nw,nwd->nd", w * b, diff)
    return s_n, F


def pairwise_terms_ref(X: torch.Tensor, Wa: torch.Tensor, Wb: torch.Tensor,
                       kind: str) -> PairwiseTerms:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    t = _pairwise_sq_dists(X)
    if kind in ("ee", "ssne"):
        a = Wa
        b = Wb * torch.exp(-t)
        e_plus = torch.sum(Wa * t)
        s = torch.sum(b)
    elif kind == "tsne":
        K = 1.0 / (1.0 + t)
        a = Wa * K
        b = Wb * K * K
        e_plus = torch.sum(Wa * torch.log1p(t))
        s = torch.sum(Wb * K)
    elif kind == "tee":
        K = 1.0 / (1.0 + t)
        a = Wa
        b = Wb * K * K
        e_plus = torch.sum(Wa * t)
        s = torch.sum(Wb * K)
    else:  # 'epan'
        a = Wa
        b = Wb * (t < 1.0).to(X.dtype)
        e_plus = torch.sum(Wa * t)
        s = torch.sum(Wb * torch.clamp_min(1.0 - t, 0.0))
    return PairwiseTerms(la_x=_lap_matmul(a, X), lb_x=_lap_matmul(b, X),
                         e_plus=e_plus, s=s)


# -- one whole Barnes-Hut evaluation from the grid state -------------------------


@dataclasses.dataclass(frozen=True)
class TreeGrid:
    """The grid state of one tree evaluation (`sparse/farfield.py`'s
    `_grid_state`): the contract of `bh_tree_ref` and of the fused kernel
    of csrc/farfield.cu.  Points are listed in sorted order, ascending by
    finest cell id; no (N, W) tensor is part of it."""

    Xs: torch.Tensor                      # (N, d) X in sorted order
    perm: torch.Tensor                    # (N,) int64: sorted position -> point
    cids: torch.Tensor                    # (N,) int64 finest cell id, ascending
    starts: torch.Tensor                  # (G^2,) int64 first sorted position
    counts: torch.Tensor                  # (G^2,) int64 occupancy
    level_counts: tuple[torch.Tensor, ...]  # (4^l,) int64, l = l1..depth
    level_com: tuple[torch.Tensor, ...]     # (4^l, d) centres of mass
    res_cnt: torch.Tensor                 # (G^2,) int64 points past `cap`
    res_com: torch.Tensor                 # (G^2, d) their centre of mass
    far_offsets: torch.Tensor             # (Wf, 2) int64 far window
    near_offsets: torch.Tensor            # (Wn, 2) int64 near window
    h: torch.Tensor                       # 0-d finest cell width
    r: int
    l1: int
    depth: int
    cap: int
    chunk: int

    @property
    def n_batches(self) -> int:
        """Far levels l1..depth, the near batch and the residual."""
        return self.depth - self.l1 + 3


def tree_slots(grid: TreeGrid) -> list[tuple[str, torch.Tensor, torch.Tensor,
                                             torch.Tensor]]:
    """Every interaction slot of an evaluation, derived from the grid state
    as the fused kernel derives it, with rows in SORTED order: (tag, idx
    (N, W) int64, w (N, W) float32, table) per batch, in the batches' order
    (far levels l1..depth, near, residual).  A point's finest cell coords
    come from its cell id; far level l tests the window at `coord >>
    (depth - l)`; near slot `slot` of cell c is sorted position `starts[c] +
    slot`, listed iff slot < count and self iff it is the row's own
    position (so the near table is Xs); the own-cell residual drops self
    iff the row's rank in its cell, `p - starts[cid]`, is >= cap."""
    n = grid.Xs.shape[0]
    D, r, cap = grid.depth, grid.r, grid.cap
    G = 1 << D
    p = torch.arange(n, dtype=torch.int64, device=grid.Xs.device)
    cx, cy = grid.cids >> D, grid.cids & (G - 1)
    far, near = grid.far_offsets, grid.near_offsets
    out = []
    for lev, cnt, com in zip(range(grid.l1, D + 1), grid.level_counts,
                             grid.level_com):
        Gl = 1 << lev
        clx, cly = (cx >> (D - lev))[:, None], (cy >> (D - lev))[:, None]
        tx, ty = clx + far[None, :, 0], cly + far[None, :, 1]
        inb = (tx >= 0) & (tx < Gl) & (ty >= 0) & (ty < Gl)
        pd = torch.maximum(torch.abs((tx >> 1) - (clx >> 1)),
                           torch.abs((ty >> 1) - (cly >> 1)))
        tcell = torch.clamp(tx, 0, Gl - 1) * Gl + torch.clamp(ty, 0, Gl - 1)
        w = torch.where(inb & (pd <= r), cnt[tcell], 0).to(torch.float32)
        out.append((f"far-l{lev}", tcell, w, com))
    tx, ty = cx[:, None] + near[None, :, 0], cy[:, None] + near[None, :, 1]
    inb = (tx >= 0) & (tx < G) & (ty >= 0) & (ty < G)
    tcell = torch.clamp(tx, 0, G - 1) * G + torch.clamp(ty, 0, G - 1)
    tcount = torch.where(inb, grid.counts[tcell], 0)          # (N, Wn)
    slot = torch.arange(cap, dtype=torch.int64, device=p.device)
    pos = grid.starts[tcell][:, :, None] + slot               # (N, Wn, cap)
    listed = slot < tcount[:, :, None]
    w = (listed & (pos != p[:, None, None])).to(torch.float32)
    out.append(("near", torch.clamp(pos, 0, n - 1).reshape(n, -1),
                w.reshape(n, -1), grid.Xs))
    own = (near[:, 0] == 0) & (near[:, 1] == 0)               # (Wn,)
    spill = (p - grid.starts[grid.cids] >= cap)[:, None] & own[None, :]
    w = torch.where(inb, grid.res_cnt[tcell], 0) - spill.long()
    out.append(("residual", tcell, torch.clamp_min(w, 0).to(torch.float32),
                grid.res_com))
    return out


def bh_tree_ref(grid: TreeGrid, kind: str
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole tree evaluation (the contract of the fused kernel of
    csrc/farfield.cu): `bh_interaction_ref` over every batch of
    `tree_slots`, each in <= chunk-wide column slices, summed in the
    batches' order.  Returns (s_rows (n_batches, N), one row of s_n a
    batch, and F (N, d) summed over the batches), both float32 and in the
    original point order."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    n = grid.Xs.shape[0]
    F = torch.zeros(grid.Xs.shape, dtype=torch.float32, device=grid.Xs.device)
    rows = []
    for _, idx, w, table in tree_slots(grid):
        s_b = torch.zeros((n,), dtype=torch.float32, device=F.device)
        F_b = torch.zeros_like(F)
        for c0 in range(0, idx.shape[1], grid.chunk):
            sl = slice(c0, c0 + grid.chunk)
            si, Fi = bh_interaction_ref(grid.Xs, idx[:, sl], w[:, sl], table,
                                        kind)
            s_b = s_b + si
            F_b = F_b + Fi
        rows.append(s_b)
        F = F + F_b
    s_rows = torch.empty((len(rows), n), dtype=torch.float32, device=F.device)
    s_rows[:, grid.perm] = torch.stack(rows)
    F_out = torch.empty_like(F)
    F_out[grid.perm] = F
    return s_rows, F_out
