"""Hessian structure of the generic embedding objective (paper eqs. (2)-(3)).

Port of `repro/core/hessians.py`.  For normalized symmetric models:

    H = 4 L (x) I_d  +  8 L^xx  -  16 lam vec(L^q X) vec(L^q X)^T

with Laplacian weights (K1 etc. evaluated at t_nm = ||x_n - x_m||^2):

    w_nm        = -K1 (p_nm - lam q_nm)
    w^q_nm      = K1 q_nm
    w^xx_{in,jm}= -(K21 p_nm - lam K2 q_nm) (x_in - x_im)(x_jn - x_jm)

For unnormalized models E = sum f_nm(t_nm):

    H = 4 L(f') (x) I_d + 8 L^xx(f'' . Delta_i Delta_j)

These dense forms are used by the DiagH and SD- strategies and by the tests
(the assembled full Hessian against autograd of the direct energy).  All
O(N^2) memory: benchmark scale, not the production path.

Index convention: X is (N, d); the flattened Hessian uses (n, i) -> n*d + i,
matching X.reshape(-1).
"""
from __future__ import annotations

import torch

from .affinities import Affinities, sq_distances
from .objectives import gradient_weights


def _pair_quantities(X: torch.Tensor, aff: Affinities, kind: str, lam):
    """Returns (c, wq) where c_nm is the scalar factor of w^xx (so that
    w^xx_{in,jm} = c_nm Delta_i Delta_j) and wq the L^q weights (or None)."""
    t = sq_distances(X)
    Wp, Wm = aff.Wp, aff.Wm
    if kind == "ee":
        return lam * Wm * torch.exp(-t), None
    if kind == "ssne":
        G = Wm * torch.exp(-t)
        q = G / torch.sum(G)
        # K21 = 0, K2 = 1:  c = lam q ;  w^q = K1 q = -q
        return lam * q, -q
    if kind == "tsne":
        K = 1.0 / (1.0 + t)
        KW = Wm * K
        q = KW / torch.sum(KW)
        # K21 = K^2, K2 = 2K^2:  c = -(p - 2 lam q) K^2 ;  w^q = -q K
        return -(Wp - 2.0 * lam * q) * K * K, -q * K
    if kind == "tee":
        K = 1.0 / (1.0 + t)
        # f- = lam w- K, f-'' = 2 lam w- K^3
        return 2.0 * lam * Wm * K ** 3, None
    if kind == "epan":
        # piecewise linear repulsion: f-'' = 0 a.e.
        return torch.zeros_like(t), None
    raise ValueError(f"unknown kind {kind!r}")


def _lap(W: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.sum(W, dim=-1)) - W


def _xx_from_c(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """wxx[i] = c * Delta_i * Delta_i, (d, N, N), one dimension at a time:
    one (N, N) temporary beside the result, the reference's bits."""
    out = torch.empty((X.shape[1],) + c.shape, dtype=c.dtype,
                      device=c.device)
    for i in range(X.shape[1]):
        diff = X[:, i, None] - X[None, :, i]
        torch.mul(c, diff, out=out[i]).mul_(diff)
    return out


def _lq_from_wq(X: torch.Tensor, wq: torch.Tensor | None):
    if wq is None:
        return None
    return torch.sum(wq, dim=-1)[:, None] * X - wq @ X


def xx_weights_ii(X: torch.Tensor, aff: Affinities, kind: str, lam
                  ) -> torch.Tensor:
    """Same-dimension (i = j) w^xx weights, shape (d, N, N):
    wxx[i] = c * (Delta x_i)^2 — the ingredients of the SD- strategy."""
    c, _ = _pair_quantities(X, aff, kind, lam)
    return _xx_from_c(X, c)


def lq_matmul(X: torch.Tensor, aff: Affinities, kind: str, lam
              ) -> torch.Tensor | None:
    """(L^q X) as (N, d), or None for unnormalized models."""
    return _lq_from_wq(X, _pair_quantities(X, aff, kind, lam)[1])


def diag_hessian(X: torch.Tensor, aff: Affinities, kind: str, lam
                 ) -> torch.Tensor:
    """Exact diagonal of the full Hessian, shape (N, d) — DiagH strategy.
    The pair quantities are formed once, and the same-dimension degrees one
    dimension at a time, so no (d, N, N) tensor is held."""
    deg_w = torch.sum(gradient_weights(X, aff, kind, lam), dim=-1)   # (N,)
    c, wq = _pair_quantities(X, aff, kind, lam)
    deg_xx = torch.stack(
        [torch.sum(_xx_from_c(X[:, i:i + 1], c)[0], dim=-1)
         for i in range(X.shape[1])], dim=1)                        # (N, d)
    diag = 4.0 * deg_w[:, None] + 8.0 * deg_xx
    lqx = _lq_from_wq(X, wq)
    if lqx is not None:
        diag = diag - 16.0 * lam * lqx * lqx
    return diag


def full_hessian(X: torch.Tensor, aff: Affinities, kind: str, lam
                 ) -> torch.Tensor:
    """Assembled dense Hessian (N*d, N*d) per eqs. (2)-(3).  Test oracle,
    (N d)^2 memory: small N only."""
    n, d = X.shape
    w = gradient_weights(X, aff, kind, lam)
    c, wq = _pair_quantities(X, aff, kind, lam)
    diff = X.T[:, :, None] - X.T[:, None, :]        # (d, N, N)

    H = torch.zeros((n, d, n, d), dtype=X.dtype, device=X.device)
    Lw = _lap(w)
    for i in range(d):
        H[:, i, :, i] += 4.0 * Lw
        for j in range(d):
            H[:, i, :, j] += 8.0 * _lap(c * diff[i] * diff[j])
    H = H.reshape(n * d, n * d)
    lqx = _lq_from_wq(X, wq)
    if lqx is not None:
        u = lqx.reshape(-1)
        H = H - 16.0 * lam * torch.outer(u, u)
    return H
