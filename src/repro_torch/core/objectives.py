"""The generic embedding objective E(X; lam) = E+(X) + lam * E-(X) (paper §1).

Port of `repro/core/objectives.py`: the dense half (`energy_and_grad`) and
the sparse half (`energy_and_grad_sparse`, over an ELL neighbour graph with
sampled negatives).  Model families
(`kind`): 'ee' (elastic embedding), 'ssne' (symmetric SNE), 'tsne' (t-SNE),
'tee' (t-EE) and 'epan' (Epanechnikov EE).

Gradients are computed in the paper's Laplacian form, grad = 4 L(w) X,
through the fused pairwise contract (kernels/ops.py):

  unnormalized:  E = e_plus + lam*s          grad = 4 (L(a)X - lam   * L(b)X)
  normalized:    E = e_plus + lam*log(s)     grad = 4 (L(a)X - lam/s * L(b)X)

`direct_energy` is the textbook form, used only to check the Laplacian-form
gradient against autograd in the tests.

The sparse half samples its negatives at random.  `repro` draws them with
`jax.random`, which torch cannot replay; here the draw is an argument
(`shifts=`), and `draw_shifts` makes the default one from a CPU
`torch.Generator`, so that a test can hand both packages the same draw and
a kernel run and a plain run on the GPU share theirs.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import KINDS, PairwiseTerms, negative_pair_terms
from repro_torch.sparse.linalg import sym_lap_matvec

from .affinities import Affinities, sq_distances

NORMALIZED = frozenset({"ssne", "tsne"})
UNNORMALIZED = frozenset(k for k in KINDS if k not in NORMALIZED)


def is_normalized(kind: str) -> bool:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    return kind in NORMALIZED


def _combine(terms: PairwiseTerms, kind: str, lam
             ) -> tuple[torch.Tensor, torch.Tensor]:
    if is_normalized(kind):
        e = terms.e_plus + lam * torch.log(terms.s)
        g = 4.0 * (terms.la_x - (lam / terms.s) * terms.lb_x)
    else:
        e = terms.e_plus + lam * terms.s
        g = 4.0 * (terms.la_x - lam * terms.lb_x)
    return e, g


def energy_and_grad(X: torch.Tensor, aff: Affinities, kind: str, lam,
                    **impl: Any) -> tuple[torch.Tensor, torch.Tensor]:
    terms = ops.pairwise_terms(X, aff.Wp, aff.Wm, kind, **impl)
    return _combine(terms, kind, lam)


def energy(X: torch.Tensor, aff: Affinities, kind: str, lam,
           **impl: Any) -> torch.Tensor:
    return energy_and_grad(X, aff, kind, lam, **impl)[0]


def grad(X: torch.Tensor, aff: Affinities, kind: str, lam,
         **impl: Any) -> torch.Tensor:
    return energy_and_grad(X, aff, kind, lam, **impl)[1]


def direct_energy(X: torch.Tensor, aff: Affinities, kind: str, lam
                  ) -> torch.Tensor:
    """Textbook dense form of E (for autodiff verification only)."""
    t = sq_distances(X)
    Wp, Wm = aff.Wp, aff.Wm
    if kind == "ee":
        return torch.sum(Wp * t) + lam * torch.sum(Wm * torch.exp(-t))
    if kind == "ssne":
        s = torch.sum(Wm * torch.exp(-t))
        return torch.sum(Wp * t) + lam * torch.log(s)
    if kind == "tsne":
        K = 1.0 / (1.0 + t)
        s = torch.sum(Wm * K)
        return torch.sum(Wp * torch.log1p(t)) + lam * torch.log(s)
    if kind == "tee":
        K = 1.0 / (1.0 + t)
        return torch.sum(Wp * t) + lam * torch.sum(Wm * K)
    if kind == "epan":
        return torch.sum(Wp * t) + lam * torch.sum(
            Wm * torch.clamp_min(1.0 - t, 0.0))
    raise ValueError(f"unknown kind {kind!r}")


def gradient_weights(X: torch.Tensor, aff: Affinities, kind: str, lam
                     ) -> torch.Tensor:
    """Dense gradient-Laplacian weights w so that grad = 4 L(w) X (paper
    eqs. (2)-(3)).  O(N^2) memory."""
    t = sq_distances(X)
    Wp, Wm = aff.Wp, aff.Wm
    if kind == "ee":
        return Wp - lam * Wm * torch.exp(-t)
    if kind == "ssne":
        G = Wm * torch.exp(-t)
        return Wp - lam * (G / torch.sum(G))
    if kind == "tsne":
        K = 1.0 / (1.0 + t)
        KW = Wm * K
        return (Wp - lam * (KW / torch.sum(KW))) * K
    if kind == "tee":
        K = 1.0 / (1.0 + t)
        return Wp - lam * Wm * K * K
    if kind == "epan":
        return Wp - lam * Wm * (t < 1.0).to(X.dtype)
    raise ValueError(f"unknown kind {kind!r}")


def directed_lap_apply(w: torch.Tensor, x: torch.Tensor, xj: torch.Tensor
                       ) -> torch.Tensor:
    """Rows of the directed Laplacian product from pre-gathered neighbours:
    (sum_j w_nj) x_n - sum_j w_nj x_{j(n)}, with w (N, k), x (N, d), xj
    (N, k, d).  The one spelling of this accumulation shared by the
    gather-only edge sweeps: the sampled-negative halves and t-SNE's
    K-reweighted attractive halves."""
    return (torch.sum(w, dim=1, keepdim=True) * x
            - torch.einsum("nk,nkd->nd", w, xj))


def attractive_edge_terms(kind: str, w: torch.Tensor, t: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge attractive terms (e_pair, a) at squared distances t for
    directed edge weights w: e_pair sums to e_plus, a is the edge's
    attractive gradient-Laplacian weight.  For every kind but t-SNE a = w;
    t-SNE reweights each edge by K = 1/(1+t), a function of the symmetric
    pair distance, which keeps the implicit symmetrization gather-only."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if kind == "tsne":
        return w * torch.log1p(t), w / (1.0 + t)
    return w * t, w


def _gathered_sq_dists(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.sum((X[:, None, :] - X[idx]) ** 2, dim=-1)


def sparse_attractive_terms(X: torch.Tensor, saff, kind: str
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact attractive terms over the calibrated ELL graph: the energy
    e_plus = sum_edges e_pair and the per-edge attractive gradient weights
    `aw` (see `attractive_edge_terms`)."""
    g = saff.graph
    e_pair, aw = attractive_edge_terms(kind, g.weights,
                                       _gathered_sq_dists(X, g.indices))
    return torch.sum(e_pair), aw


def sparse_attractive_lap(X: torch.Tensor, saff, kind: str,
                          aw: torch.Tensor, impl: str = "auto"
                          ) -> torch.Tensor:
    """The attractive Laplacian product la_x = L(a) X over the implicit
    symmetric W+ = (A + A^T)/2, gather-only.  For every kind but t-SNE the
    attractive weights are W+ itself, so this is `sym_lap_matvec` (the ELL
    kernel dispatcher with the given `impl`, in float32 storage); t-SNE's
    reverse edges recompute their K from their own distance."""
    g = saff.graph
    rev = saff.rev
    if kind == "tsne":
        if rev is None:
            raise ValueError(
                "sparse tsne needs the precomputed reverse graph (saff.rev) "
                "to keep the K-reweighted transpose half gather-only")
        arw = attractive_edge_terms(kind, rev.weights,
                                    _gathered_sq_dists(X, rev.indices))[1]
        return 0.5 * (directed_lap_apply(aw, X, X[g.indices])
                      + directed_lap_apply(arw, X, X[rev.indices]))
    return sym_lap_matvec(g, X, rev=rev, impl=impl)


def draw_shifts(seed: int, it: int, n: int, m: int,
                device) -> torch.Tensor:
    """m distinct cyclic shifts in 1..n-1 (int32), the sampled negatives of
    iteration `it`: drawn on the CPU from a generator seeded by (seed, it),
    then moved to `device`.  The counterpart of the reference's
    `1 + jax.random.choice(fold_in(PRNGKey(seed), it), n - 1, (m,),
    replace=False)`; it gives other numbers from the same seed."""
    g = torch.Generator().manual_seed((seed << 32) + it)
    shifts = (1 + torch.randperm(n - 1, generator=g)[:m]).to(torch.int32)
    if torch.device(device).type == "cuda":
        # an explicit, asynchronous upload from pinned memory: the host
        # does not wait on the card (analysis.guards.no_implicit_transfers)
        return shifts.pin_memory().to(device, non_blocking=True)
    return shifts.to(device)


def energy_and_grad_sparse(X: torch.Tensor, saff, kind: str, lam, *,
                           n_negatives: int | None = 5,
                           shifts: torch.Tensor | None = None,
                           with_grad: bool = True,
                           z_prev: torch.Tensor | None = None,
                           z_decay=0.9, return_state: bool = False,
                           impl: str = "auto"):
    """O(N (k + m) d) energy and gradient for every model family.

    Attractive side: exact, over the calibrated ELL graph (the implicit
    symmetric W+ = (A + A^T)/2).

    Repulsive side: W- = 1 off-diagonal, estimated by CYCLIC-SHIFT negative
    sampling: row n's negatives are {(n + s_j) mod N} for the m distinct
    `shifts` s_j in 1..N-1 (`draw_shifts`).  Scaling per-pair terms by
    (N-1)/m makes s_hat and L(b_hat) X unbiased in absolute scale.  The
    transpose of the sampled edge set is the negated shifts, so the
    symmetric application is pure gathers.

    Normalized models (ssne/tsne) reuse the draw as a ratio estimator of the
    partition function: the energy uses log(s_hat), and the gradient's 1/Z
    factor a streaming estimate z = z_decay z_prev + (1 - z_decay) s_hat
    (z_prev None or <= 0: z = s_hat), returned with `return_state=True` as
    a third value.

    `n_negatives=None` (or >= N-1) uses all N-1 shifts, every ordered pair
    exactly once: exact, no draw needed, and z = s_hat = Z.
    `with_grad=False` returns (E, None): the line search needs no gradient.
    `impl` selects the path of the ELL products (`kernels.ops`); their
    storage stays float32, as the reference's.
    """
    normalized = is_normalized(kind)
    if return_state and not normalized:
        raise ValueError(
            f"return_state threads the partition-function estimate, which "
            f"only normalized kinds carry (got {kind!r})")
    n = X.shape[0]
    dev = X.device
    e_plus, aw = sparse_attractive_terms(X, saff, kind)

    exhaustive = n_negatives is None or n_negatives >= n - 1
    if exhaustive:
        shifts = torch.arange(1, n, dtype=torch.int32, device=dev)
        scale = 1.0
    else:
        if shifts is None:
            raise ValueError("sampled negatives need their shifts "
                             "(draw_shifts)")
        if shifts.shape != (n_negatives,):
            raise ValueError(f"shifts must be ({n_negatives},), got "
                             f"{tuple(shifts.shape)}")
        shifts = shifts.to(device=dev, dtype=torch.int32)
        scale = (n - 1) / n_negatives
    rows = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    J = (rows + shifts[None, :]) % n                        # (N, m)

    s_pair, b = negative_pair_terms(kind, _gathered_sq_dists(X, J))
    s_hat = scale * torch.sum(s_pair)

    if normalized:
        E = e_plus + lam * torch.log(s_hat)
        if exhaustive or z_prev is None:
            z = s_hat
        else:
            # z_decay in float32, as the reference's traced argument
            zd = torch.full((), z_decay, dtype=X.dtype, device=dev)
            z = torch.where(z_prev > 0, zd * z_prev + (1.0 - zd) * s_hat,
                            s_hat)
    else:
        E = e_plus + lam * s_hat
        z = None
    if not with_grad:
        return (E, None, z) if return_state else (E, None)

    la_x = sparse_attractive_lap(X, saff, kind, aw, impl)

    # forward slot j is shift +s_j with weights b[:, j]; the transpose is
    # shift -s_j carrying the same per-edge weight, read at the source row
    Jr = (rows - shifts[None, :]) % n                       # (N, m)
    b_rev = b[Jr.long(), torch.arange(shifts.shape[0], device=dev)[None, :]]
    lb_x = 0.5 * scale * (directed_lap_apply(b, X, X[J])
                          + directed_lap_apply(b_rev, X, X[Jr]))

    lam_rep = (lam / z) if normalized else lam
    G = 4.0 * (la_x - lam_rep * lb_x)
    return (E, G, z) if return_state else (E, G)


def attractive_weights(aff: Affinities, kind: str) -> torch.Tensor:
    """Weights of the attractive (spectral) Hessian 4 L+ (x) I_d.

    For EE / s-SNE the attractive Hessian is exactly 4 L(W+).  For t-SNE it
    depends on X; as in the paper it is frozen at X = 0, which gives the same
    L(P) and keeps the cached Cholesky factor valid (likewise t-EE and
    Epanechnikov)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    return aff.Wp
