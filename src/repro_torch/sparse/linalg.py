"""Sparse Laplacian operators over ELL graphs, and preconditioned CG.

Port of `repro/sparse/linalg.py`.  All operators apply the SYMMETRIC weight
matrix W = (A + A^T)/2 implicitly from the directed ELL storage (graph.py):

    W X       = (A X + A^T X) / 2
    deg(W)    = (out_degree + in_degree)/2
    L(W) X    = deg(W) * X - W X

With the reverse graph A^T at hand both halves of L(W) X are directed
Laplacian row gathers through `kernels.ops.ell_lap_matvec`, the CUDA kernel
of csrc/ell.cu on the GPU.  That is the hot path: the conjugate-gradient
solve of the spectral direction applies it once per CG iteration.

The spectral-direction solve B p = -g with B = 4 L(W+) + mu I never forms
(N, N): `pcg` is Jacobi-preconditioned CG on the (N, d) right-hand side.
The reference runs it as one device `while_loop`; here it is a host loop
that reads one flag (the reference's stopping test, evaluated on the device
in float32) per CG iteration, so both stop after the same iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.analysis.guards import explicit_read
from repro_torch.kernels import ops

from .graph import NeighborGraph


def out_degree(g: NeighborGraph) -> torch.Tensor:
    """Row sums of A (padded slots have zero weight)."""
    return torch.sum(g.weights, dim=-1)


def in_degree(g: NeighborGraph) -> torch.Tensor:
    """Column sums of A.  A segment sum over the edges sorted by column
    (stable, so each column sums its edges in row order) rather than a
    scatter-add, whose float atomics would make reruns differ on CUDA."""
    cols, order = torch.sort(g.indices.reshape(-1), stable=True)
    counts = torch.bincount(cols, minlength=g.n)
    return torch.segment_reduce(g.weights.reshape(-1)[order], "sum",
                                lengths=counts)


def sym_degree(g: NeighborGraph) -> torch.Tensor:
    """Degrees of the implicit W = (A + A^T)/2."""
    return 0.5 * (out_degree(g) + in_degree(g))


def ell_matvec(g: NeighborGraph, X: torch.Tensor) -> torch.Tensor:
    """A @ X by row gather: sum_j w_nj * X[i_nj]."""
    return torch.einsum("nk,nkd->nd", g.weights, X[g.indices])


def ell_t_matvec(g: NeighborGraph, X: torch.Tensor) -> torch.Tensor:
    """A^T @ X by scatter-add: row m accumulates w_nm * X[n].  On CUDA the
    scatter sums with atomics; the fit path uses the reverse graph
    instead."""
    contrib = (g.weights[:, :, None] * X[:, None, :]).reshape(-1, X.shape[1])
    return torch.zeros_like(X).index_add_(0, g.indices.reshape(-1).long(),
                                          contrib)


def sym_lap_matvec(g: NeighborGraph, X: torch.Tensor,
                   rev: NeighborGraph | None = None, **impl) -> torch.Tensor:
    """L((A + A^T)/2) @ X in O(N k d), as (L(A)X + L(A^T)X) / 2.

    With `rev` (the precomputed transpose ELL, graph.reverse_graph) both
    halves go through the kernel dispatcher (`kernels.ops.ell_lap_matvec`;
    `impl` kwargs are forwarded).  Without it the transpose half is a
    scatter-add."""
    la_x = ops.ell_lap_matvec(X, g.indices, g.weights, **impl)
    if rev is not None:
        lat_x = ops.ell_lap_matvec(X, rev.indices, rev.weights, **impl)
    else:
        lat_x = in_degree(g)[:, None] * X - ell_t_matvec(g, X)
    return 0.5 * (la_x + lat_x)


def make_sd_operator(g: NeighborGraph, rev: NeighborGraph | None,
                     mu_scale: float = 1e-5, **impl):
    """(matvec, inv_diag, mu) for the sparse spectral-direction system
    B = 4 L((A + A^T)/2) + mu I.  `impl` kwargs (``impl``, ``layout``,
    ``storage_dtype``) are forwarded to the kernel dispatcher for every
    matvec: this is the CG hot path."""
    bd = 4.0 * sym_degree(g)
    mu = torch.maximum(1e-10 * torch.min(bd), mu_scale * torch.mean(bd))
    inv_diag = 1.0 / (bd + mu)

    def matvec(V):
        return 4.0 * sym_lap_matvec(g, V, rev=rev, **impl) + mu * V

    return matvec, inv_diag, mu


def sym_matvec(g: NeighborGraph, X: torch.Tensor,
               rev: NeighborGraph | None = None) -> torch.Tensor:
    """W @ X for the implicit W = (A + A^T)/2.  With `rev` both halves are
    row gathers; without it the transpose half is a scatter-add."""
    ax = ell_matvec(g, X)
    atx = ell_matvec(rev, X) if rev is not None else ell_t_matvec(g, X)
    return 0.5 * (ax + atx)


def draw_start_block(n: int, cols: int, seed: int, dtype,
                     device) -> torch.Tensor:
    """The random starting block of `sparse_laplacian_eigenmaps`, (n, cols),
    drawn on the CPU from `seed` and moved to `device`."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, cols), generator=g, dtype=dtype).to(device)


def sparse_laplacian_eigenmaps(g: NeighborGraph,
                               rev: NeighborGraph | None = None,
                               d: int = 2, n_iters: int = 300,
                               oversample: int = 6, seed: int = 0,
                               V0: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Laplacian-eigenmaps start from ELL storage: O(N k d) per sweep, no
    (N, N) array; the sparse analogue of core.spectral_init.

    The bottom nontrivial eigenvectors of the normalized Laplacian, i.e. the
    TOP eigenvectors of M = D^{-1/2} W D^{-1/2}, by block subspace iteration
    on M + I (spectrum in [0, 2]), then a Rayleigh-Ritz projection.  The
    block carries `oversample` extra vectors.  Same gauge as the dense
    routine: drop the trivial top eigenvector, map back through D^{-1/2},
    center, unit std per dimension.  `V0` (N, min(d + 1 + oversample, N))
    replaces the random starting block drawn from `seed`."""
    n = g.n
    dg = torch.clamp_min(sym_degree(g) if rev is None
                         else 0.5 * (out_degree(g) + out_degree(rev)), 1e-12)
    dinv = 1.0 / torch.sqrt(dg)

    def Mv(V):
        return dinv[:, None] * sym_matvec(g, dinv[:, None] * V, rev=rev)

    cols = min(d + 1 + oversample, n)
    if V0 is None:
        V0 = draw_start_block(n, cols, seed, g.weights.dtype,
                              g.weights.device)
    V, _ = torch.linalg.qr(V0.to(device=g.weights.device,
                                 dtype=g.weights.dtype))
    for _ in range(n_iters):
        V, _ = torch.linalg.qr(Mv(V) + V)
    # Rayleigh-Ritz: order the converged subspace by eigenvalue of M
    T = V.T @ Mv(V)
    _, S = torch.linalg.eigh(0.5 * (T + T.T))   # ascending
    U = V @ S.flip(-1)                          # descending: col 0 trivial
    X = dinv[:, None] * U[:, 1:d + 1]
    X = X - torch.mean(X, dim=0, keepdim=True)
    return X / torch.clamp_min(torch.std(X, dim=0, correction=0,
                                         keepdim=True), 1e-12)


# -- preconditioned CG ----------------------------------------------------------


def _above(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a > b read back to the host: PCG's one flag a CG step, the
    reference's stopping rule (`analysis.guards.explicit_read`)."""
    flag = a > b
    with explicit_read():
        return bool(flag)


class PCGResult(NamedTuple):
    x: torch.Tensor             # (N, d)
    n_iters: int
    rel_residual: torch.Tensor  # 0-d


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], B: torch.Tensor,
        x0: torch.Tensor, inv_diag: torch.Tensor | None = None,
        tol: float = 1e-2, maxiter: int = 100) -> PCGResult:
    """Preconditioned conjugate gradients on a multi-column RHS.

    All columns share the same SPD operator, so the d systems run fused:
    one operator application per iteration, scalar products summed over
    all columns.  Stops when ||r|| <= tol ||B|| or after `maxiter`
    iterations, the reference's rule, tested in float32 on the device with
    one flag read back per iteration."""
    precond = ((lambda r: inv_diag[:, None] * r) if inv_diag is not None
               else (lambda r: r))

    def vdot(a, b):
        return torch.dot(a.reshape(-1), b.reshape(-1))

    b_norm = torch.clamp_min(torch.linalg.norm(B), 1e-30)
    x = x0
    r = B - matvec(x0)
    p = precond(r)
    rz = vdot(r, p)
    k = 0
    while k < maxiter and _above(torch.linalg.norm(r), tol * b_norm):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(vdot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = vdot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        k += 1
    return PCGResult(x=x, n_iters=k,
                     rel_residual=torch.linalg.norm(r) / b_norm)
