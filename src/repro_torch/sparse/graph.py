"""k-NN neighbour graphs in padded neighbour-list (ELL) format.

Port of `repro/sparse/graph.py` (all but `knn_cross`, which belongs to the
out-of-sample transform).  The spectral direction is scalable because
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

The approximate search draws its T projection directions at random.
`repro` draws them with `jax.random`, which torch cannot replay; the port
draws them from a CPU `torch.Generator` seeded with `seed`, and takes them
as `projections=` so that a test can hand both packages the same ones.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch


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
    (``knn_s``, ``calibrate_s``, ``reverse_s``), device work included: the
    counterpart of the reference's graph-build spans."""
    n = Y.shape[0]
    marks = [time.perf_counter()]

    def mark(t):
        _sync(t)
        marks.append(time.perf_counter())

    d2, idx = knn_graph(Y, k, method=method, **knn_kw)
    mark(d2)
    self_col = torch.arange(n, dtype=idx.dtype, device=idx.device)[:, None]
    valid = idx != self_col
    w = calibrated_weights_ell(d2, valid, perplexity)
    if model in ("ssne", "tsne"):
        w = w / n
    # padding invariant (invalid slots: self index, zero weight)
    idx = torch.where(valid, idx, self_col)
    w = torch.where(valid, w, 0.0)
    g = NeighborGraph(indices=idx, weights=w)
    mark(w)
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
