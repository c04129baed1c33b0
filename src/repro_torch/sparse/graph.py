"""k-NN neighbour graphs in padded neighbour-list (ELL) format.

Port of `repro/sparse/graph.py`.  The spectral direction is scalable because
B = 4 L+_kappa is sparse when the attractive graph is a kappa-NN graph;
this module is the storage layer that makes that sparsity real.

Format — `NeighborGraph(indices (N, k) int32, weights (N, k) float)`:

  * row n lists the columns of a DIRECTED weight matrix A: A[n, indices[n,j]]
    = weights[n, j].  Duplicate columns are allowed and sum.
  * padding invariant: an unused slot stores `indices[n, j] = n` (self) with
    `weights[n, j] = 0`, and contributes exactly zero to every operator in
    linalg.py.

The symmetric W+ = (A + A^T) / 2 is never materialized: linalg.py applies
it from A and its transpose `reverse_graph(A)`, both row gathers.

Construction is exact and blocked (O(N^2 D)), or approximate through
random-projection windows (`method="approx"`, O(T N (log N + w D))): T
random 1-D projections, candidates = a window of 2 w sorted neighbours per
projection, exact distances on the candidate union.

`knn_cross` is the cross-set search of the out-of-sample transform: the k
nearest TRAINING rows of each query row, exact (blocked) or through the same
random-projection windows.  Every query block it works on has the same
number of rows (the last one padded with zeros), so a query row's
neighbours and distances come out of the same kernels whatever the other
rows of its call.

The approximate searches draw their T projection directions at random.
`repro` draws them with `jax.random`, which torch cannot replay; the port
draws them from a CPU `torch.Generator` seeded with `seed`, and takes them
as `projections=` so that a test can hand both packages the same ones.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.obs import span


class NeighborGraph(NamedTuple):
    """Directed ELL graph: A[n, indices[n, j]] = weights[n, j]."""

    indices: torch.Tensor  # (N, k) int32
    weights: torch.Tensor  # (N, k) float

    @property
    def n(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]


class SparseAffinities(NamedTuple):
    """Sparse analogue of core.affinities.Affinities.

    graph: directed calibrated conditionals (model scaling folded into the
           weights, see `sparse_affinities`); the attractive W+ is the
           implicit (A + A^T)/2.
    rev:   the transpose A^T as a second ELL graph (`reverse_graph`), so the
           symmetric operator is two row gathers.
    Repulsive weights are implicitly W- = 1 off-diagonal, estimated by
    negative sampling (core/objectives.py).
    """

    graph: NeighborGraph
    rev: NeighborGraph | None = None


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# -- construction ---------------------------------------------------------------


def knn_graph_exact(Y: torch.Tensor, k: int, block_rows: int = 1024
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact blocked k-NN: (d2 (N, k), indices (N, k) int32), nearest
    first.  O(N^2 D) compute, O(block_rows * N) memory."""
    n = Y.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < N={n}")
    r = torch.sum(Y * Y, dim=-1)
    d2s, idxs = [], []
    for r0 in range(0, n, block_rows):
        Yb = Y[r0:r0 + block_rows]
        nb = Yb.shape[0]
        d2 = torch.clamp_min(r[r0:r0 + nb, None] + r[None, :]
                             - 2.0 * (Yb @ Y.T), 0.0)
        rows = torch.arange(nb, device=Y.device)
        d2[rows, r0 + rows] = torch.inf                 # exclude self
        vals, idx = torch.topk(d2, k, dim=-1, largest=False)
        d2s.append(vals)
        idxs.append(idx.to(torch.int32))
    return torch.cat(d2s), torch.cat(idxs)


def _dedupe_sorted_rows(idx: torch.Tensor, d2: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, sort the candidate columns and mark repeats with +inf."""
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    d2_s = torch.gather(d2, -1, order)
    dup = torch.zeros_like(idx_s, dtype=torch.bool)
    dup[:, 1:] = idx_s[:, 1:] == idx_s[:, :-1]
    return idx_s, torch.where(dup, torch.inf, d2_s)


def draw_projections(n_projections: int, dim: int, seed: int,
                     device) -> torch.Tensor:
    """The random projection directions of `knn_graph_approx`, (T, D),
    drawn on the CPU from `seed` and moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n_projections, dim), generator=g).to(device)


def knn_graph_approx(Y: torch.Tensor, k: int, n_projections: int = 8,
                     window: int = 16, seed: int = 0, block_rows: int = 1024,
                     projections: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-NN via random-projection windows.

    Candidates per point: its 2 * window neighbours in sorted order along
    each of `n_projections` random directions (union, deduped), then exact
    distances and top-k on the candidate set only.  `projections`
    (n_projections, D) replaces the draw from `seed`."""
    n = Y.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < N={n}")
    if projections is None:
        projections = draw_projections(n_projections, Y.shape[1], seed,
                                       Y.device)
    projections = projections.to(device=Y.device, dtype=Y.dtype)
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]
                     ).to(Y.device)
    ar = torch.arange(n, device=Y.device)
    cands = []
    for u in projections:
        order = torch.argsort(Y @ u, stable=True)        # (N,) point ids
        rank = torch.empty_like(order)
        rank[order] = ar                                 # point -> position
        pos = torch.clamp(rank[:, None] + offs[None, :], 0, n - 1)
        cands.append(order[pos])                         # (N, 2w)
    cand = torch.cat(cands, dim=-1)                      # (N, C)

    r = torch.sum(Y * Y, dim=-1)
    d2s, idxs = [], []
    for r0 in range(0, n, block_rows):
        Yb = Y[r0:r0 + block_rows]
        cb = cand[r0:r0 + block_rows]
        Yc = Y[cb]                                       # (br, C, D)
        d2 = torch.clamp_min(r[r0:r0 + Yb.shape[0], None] + r[cb]
                             - 2.0 * torch.einsum("bd,bcd->bc", Yb, Yc), 0.0)
        rows = ar[r0:r0 + Yb.shape[0]]
        d2 = torch.where(cb == rows[:, None], torch.inf, d2)   # exclude self
        cb_s, d2_s = _dedupe_sorted_rows(cb, d2)
        vals, slot = torch.topk(d2_s, k, dim=-1, largest=False)
        d2s.append(vals)
        idxs.append(torch.gather(cb_s, -1, slot).to(torch.int32))
    return torch.cat(d2s), torch.cat(idxs)


#: N above which ``knn_graph(method="auto")`` uses the approximate search
KNN_APPROX_N = 20_000


def knn_graph(Y: torch.Tensor, k: int, method: str = "auto", **kw
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(d2, indices), both (N, k).  `method`: 'exact' | 'approx' | 'auto'
    (exact up to N = 20000, approx above)."""
    if method == "auto":
        method = "exact" if Y.shape[0] <= KNN_APPROX_N else "approx"
    if method == "exact":
        return knn_graph_exact(Y, k, **kw)
    if method == "approx":
        return knn_graph_approx(Y, k, **kw)
    raise ValueError(f"unknown knn method {method!r}")


#: reference-set size above which ``knn_cross(method="auto")`` switches from
#: the exact blocked pass to the random-projection candidate search (the
#: threshold of `knn_graph`'s auto policy)
CROSS_APPROX_N = 20_000


def _validate_cross_k(k: int, n_r: int) -> None:
    """Up-front `knn_cross` argument check: a clear ValueError at the call
    boundary instead of a shape error from `topk` inside the blocked pass
    (the serving path hits this with a user's `k_cross` against a possibly
    tiny training set)."""
    if k < 1:
        raise ValueError(f"knn_cross needs k >= 1, got k={k}")
    if k > n_r:
        raise ValueError(
            f"knn_cross k={k} exceeds the reference-set size n_train={n_r}: "
            f"each query needs k distinct training neighbors (lower k_cross "
            f"or provide more training points)")


def _query_blocks(Yq: torch.Tensor, block_rows: int):
    """(row0, rows, block) over Yq in blocks of min(block_rows, n_q) rows,
    the last one padded with zero rows: every block has the same shape."""
    n_q = Yq.shape[0]
    br = min(block_rows, n_q)
    for r0 in range(0, n_q, br):
        Yb = Yq[r0:r0 + br]
        nb = Yb.shape[0]
        if nb < br:
            Yb = torch.cat([Yb, Yb.new_zeros((br - nb, Yb.shape[1]))])
        yield r0, nb, Yb


def _empty_cross(Yr: torch.Tensor, k: int):
    return (Yr.new_zeros((0, k)),
            torch.zeros((0, k), dtype=torch.int32, device=Yr.device))


def knn_cross_exact(Yq: torch.Tensor, Yr: torch.Tensor, k: int,
                    block_rows: int = 1024
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact blocked k-NN from QUERY rows to REFERENCE rows: (d2, indices),
    both (n_q, k), nearest first, indices (int32) into Yr.  No
    self-exclusion: the two sets are distinct by construction (new points
    against the training set).  O(n_q n_r D) compute, O(block_rows n_r)
    memory."""
    n_q, n_r = Yq.shape[0], Yr.shape[0]
    _validate_cross_k(k, n_r)
    if n_q == 0:
        return _empty_cross(Yr, k)
    r = torch.sum(Yr * Yr, dim=-1)
    d2s, idxs = [], []
    for _, nb, Yb in _query_blocks(Yq, block_rows):
        d2 = torch.clamp_min(torch.sum(Yb * Yb, dim=-1)[:, None] + r[None, :]
                             - 2.0 * (Yb @ Yr.T), 0.0)
        vals, idx = torch.topk(d2, k, dim=-1, largest=False)
        d2s.append(vals[:nb])
        idxs.append(idx[:nb].to(torch.int32))
    return torch.cat(d2s), torch.cat(idxs)


def knn_cross_approx(Yq: torch.Tensor, Yr: torch.Tensor, k: int,
                     n_projections: int = 8, window: int = 16, seed: int = 0,
                     block_rows: int = 1024,
                     projections: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate cross-set k-NN through `knn_graph_approx`'s random-
    projection windows, extended to two point sets.

    Per projection u the REFERENCE set is sorted along u (on every call),
    each query is inserted by `searchsorted`, and its candidates are the
    2 * window reference points around the insertion slot.  The candidate
    union over the projections gets exact distances and top-k; repeated
    candidates score +inf, so with k above the distinct candidates a row
    returns +inf slots.  `projections` (n_projections, D) replaces the
    draw from `seed`."""
    n_q, n_r = Yq.shape[0], Yr.shape[0]
    _validate_cross_k(k, n_r)
    cand_per_proj = min(2 * window, n_r)
    if k > n_projections * cand_per_proj:
        raise ValueError(
            f"knn_cross approx mode: k={k} exceeds the candidate budget "
            f"{n_projections} projections x {cand_per_proj} window points = "
            f"{n_projections * cand_per_proj}; raise window or n_projections "
            f"(or use method='exact')")
    if n_q == 0:
        return _empty_cross(Yr, k)
    if projections is None:
        projections = draw_projections(n_projections, Yr.shape[1], seed,
                                       Yr.device)
    projections = projections.to(device=Yr.device, dtype=Yr.dtype)
    offs = torch.arange(-window, window, device=Yr.device)
    sorted_proj = []
    for u in projections:
        pr = Yr @ u
        order = torch.argsort(pr, stable=True)           # (n_r,) ref ids
        sorted_proj.append((u, pr[order].contiguous(), order))
    d2s, idxs = [], []
    for _, nb, Yb in _query_blocks(Yq, block_rows):
        cand = torch.cat([
            order[torch.clamp(torch.searchsorted(pr_s, Yb @ u)[:, None]
                              + offs[None, :], 0, n_r - 1)]
            for u, pr_s, order in sorted_proj], dim=-1)  # (br, C)
        Yc = Yr[cand]                                    # (br, C, D)
        d2 = torch.clamp_min(
            torch.sum(Yb * Yb, dim=-1)[:, None] + torch.sum(Yc * Yc, dim=-1)
            - 2.0 * torch.einsum("bd,bcd->bc", Yb, Yc), 0.0)
        cb_s, d2_s = _dedupe_sorted_rows(cand, d2)
        vals, slot = torch.topk(d2_s, k, dim=-1, largest=False)
        d2s.append(vals[:nb])
        idxs.append(torch.gather(cb_s, -1, slot)[:nb].to(torch.int32))
    return torch.cat(d2s), torch.cat(idxs)


def knn_cross(Yq: torch.Tensor, Yr: torch.Tensor, k: int,
              block_rows: int = 1024, method: str = "exact", **approx_kw
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-set k-NN dispatch: (d2, indices), both (n_q, k), indices into
    the reference rows `Yr`.  `method`: 'exact' (blocked O(n_q n_r D)
    pass) | 'approx' (`knn_cross_approx`) | 'auto' (exact up to n_r =
    CROSS_APPROX_N, approx above: queries against a large frozen training
    set must not pay a full scan).  Validates 1 <= k <= n_reference up
    front."""
    _validate_cross_k(k, Yr.shape[0])
    if method == "auto":
        method = "exact" if Yr.shape[0] <= CROSS_APPROX_N else "approx"
    if method == "exact":
        return knn_cross_exact(Yq, Yr, k, block_rows=block_rows)
    if method == "approx":
        return knn_cross_approx(Yq, Yr, k, block_rows=block_rows,
                                **approx_kw)
    raise ValueError(f"unknown knn_cross method {method!r}; "
                     f"have 'exact' | 'approx' | 'auto'")


# -- perplexity calibration over k candidates -----------------------------------


def _entropy_probs_ell(d2: torch.Tensor, beta: torch.Tensor,
                       valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Entropy (nats) and probabilities of every row over its valid slots."""
    logits = torch.where(valid, -beta[:, None] * d2, -torch.inf)
    logits = logits - torch.amax(logits, dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(logits), 0.0)
    p = e / torch.sum(e, dim=-1, keepdim=True)
    plogp = torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-37)), 0.0)
    return -torch.sum(plogp, dim=-1), p


def calibrated_weights_ell(d2: torch.Tensor, valid: torch.Tensor,
                           perplexity: float, n_iter: int = 60
                           ) -> torch.Tensor:
    """Per-row bisection on beta over only the k candidate distances, so
    H(P_n) = log(perplexity); all rows at once.  The algorithm of
    core.affinities.calibrated_conditionals, restricted to the neighbour
    list; `valid` masks padded slots (their probability is exactly 0).

    With perplexity >= k the target log(perplexity) exceeds the k-atom
    maximum log(k), and the row degenerates to uniform over its
    candidates: keep k >~ 3 * perplexity."""
    target = torch.log(torch.tensor(perplexity, dtype=d2.dtype,
                                    device=d2.device))
    lo = torch.zeros(d2.shape[0], dtype=d2.dtype, device=d2.device)
    hi = torch.full_like(lo, torch.inf)
    beta = torch.ones_like(lo)
    for _ in range(n_iter):
        h, _ = _entropy_probs_ell(d2, beta, valid)
        too_high = h > target          # too much entropy: raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    return _entropy_probs_ell(d2, beta, valid)[1]


def sparse_affinities(Y: torch.Tensor, k: int, perplexity: float = 30.0,
                      model: str = "ee", method: str = "auto",
                      timings: dict | None = None,
                      **knn_kw) -> SparseAffinities:
    """Sparse analogue of core.affinities.make_affinities.

    The stored directed weights A are the calibrated conditionals P_cond
    (restricted to k candidates), scaled so that the implicit symmetric
    (A + A^T)/2 matches the dense convention:

      EE-family:          W+ = (P_cond + P_cond^T) / 2      -> A = P_cond
      normalized models:  W+ = (P_cond + P_cond^T) / (2N)   -> A = P_cond / N

    `timings`, when given, receives the seconds of the three build steps
    (``knn_s``, ``calibrate_s``, ``reverse_s``), device work included.  The
    same steps run under the reference's spans (``graph-build`` with
    ``graph-build/knn``, ``/calibrate`` and ``/reverse``), each closing
    after its step's synchronisation."""
    n = Y.shape[0]
    marks = [time.perf_counter()]

    def mark(t):
        _sync(t)
        marks.append(time.perf_counter())

    with span("graph-build", phase=True, n=n, k=k):
        with span("graph-build/knn", method=method):
            d2, idx = knn_graph(Y, k, method=method, **knn_kw)
            mark(d2)
        self_col = torch.arange(n, dtype=idx.dtype,
                                device=idx.device)[:, None]
        valid = idx != self_col
        with span("graph-build/calibrate", perplexity=perplexity):
            w = calibrated_weights_ell(d2, valid, perplexity)
            if model in ("ssne", "tsne"):
                w = w / n
            # padding invariant (invalid slots: self index, zero weight)
            idx = torch.where(valid, idx, self_col)
            w = torch.where(valid, w, 0.0)
            g = NeighborGraph(indices=idx, weights=w)
            mark(w)
        with span("graph-build/reverse"):
            rev = reverse_graph(g)
            mark(rev.weights)
    if timings is not None:
        for name, t0, t1 in zip(("knn_s", "calibrate_s", "reverse_s"),
                                marks, marks[1:]):
            timings[name] = t1 - t0
    return SparseAffinities(graph=g, rev=rev)


def reverse_graph(g: NeighborGraph, width: int | None = None
                  ) -> NeighborGraph:
    """The transpose A^T as an ELL graph: row m lists every n with an edge
    n -> m, at A's weight, sources in increasing order.  Row width is the
    largest in-degree (read back to the host: a build-time step); shorter
    rows get the standard padding (self index, zero weight).  Padded slots
    of A (zero-weight self edges) carry their zero weight into the reverse
    rows and still contribute nothing."""
    n, k = g.indices.shape
    dev = g.indices.device
    src = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(k)
    dst = g.indices.reshape(-1).to(torch.int32)
    w = g.weights.reshape(-1)
    if width is None:
        width = int(torch.bincount(dst, minlength=n).max())
    dsts, order = torch.sort(dst, stable=True)
    srcs, ws = src[order], w[order]
    # slot of each edge within its destination row
    row_start = torch.searchsorted(
        dsts, torch.arange(n, dtype=dsts.dtype, device=dev))
    slot = torch.arange(n * k, device=dev) - row_start[dsts.long()]
    rev_idx = torch.full((n, width), -1, dtype=torch.int32, device=dev)
    rev_w = torch.zeros((n, width), dtype=g.weights.dtype, device=dev)
    rev_idx[dsts.long(), slot] = srcs
    rev_w[dsts.long(), slot] = ws
    self_col = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    return NeighborGraph(indices=torch.where(rev_idx < 0, self_col, rev_idx),
                         weights=rev_w)


# -- dense conversions ----------------------------------------------------------


def from_dense(W: torch.Tensor, k: int) -> NeighborGraph:
    """Top-k per row of a dense weight matrix as a directed ELL graph.  The
    diagonal is excluded; rows with fewer than k nonzeros get padded slots
    (self index, zero weight)."""
    n = W.shape[0]
    k = min(k, n - 1)
    Wo = W.clone().fill_diagonal_(-torch.inf)
    vals, idx = torch.topk(Wo, k, dim=-1)
    keep = vals > 0
    self_col = torch.arange(n, device=W.device)[:, None]
    idx = torch.where(keep, idx, self_col).to(torch.int32)
    return NeighborGraph(indices=idx, weights=torch.where(keep, vals, 0.0))


def to_dense(g: NeighborGraph) -> torch.Tensor:
    """Dense directed A with duplicate slots summed; padded slots (zero
    weight) add nothing although they target the diagonal."""
    n = g.n
    rows = torch.arange(n, device=g.indices.device)[:, None].expand(
        -1, g.k)
    A = torch.zeros((n, n), dtype=g.weights.dtype, device=g.weights.device)
    return A.index_put_((rows.reshape(-1), g.indices.reshape(-1).long()),
                        g.weights.reshape(-1), accumulate=True)
