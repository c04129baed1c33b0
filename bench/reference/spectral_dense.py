"""The check of a spectral (Laplacian-eigenmaps) start on the dense
backend, in float64.

The start's columns should be the bottom nontrivial generalized
eigenvectors of (L+, D+): in the symmetric form, the eigenvectors of
M = D^-1/2 W+ D^-1/2 with the second, third, ... largest eigenvalues,
mapped back through D^-1/2, centred and scaled.  Centring adds a multiple
of the trivial vector, so each column is first D-orthogonalised against
it.  Where the graph's clusters barely touch, the top eigenvalues of M
crowd at 1 and their eigenvectors are fixed only up to rounding within
the group; so the start is not compared vector by vector but by two
readings on M's own scale (its spectrum lies in [-1, 1]):

  * `resid`: ||M u - theta u|| for the column's u = D^1/2 v / ||.|| and its
    Rayleigh quotient theta: is it an eigenvector at all;
  * `rank`: how far a Ritz value of the reference's own subspace iteration
    lies above the column's theta.  Ritz values bound the true eigenvalues
    from below, so a sound start reads 0 however far the iteration got,
    and a start built from the wrong eigenvectors reads the gap to the one
    it missed."""
from __future__ import annotations

import torch

from reference.gaps import worst


def _ritz_values(Mv, n: int, device, block: int, iters: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(0)
    V = torch.linalg.qr(torch.randn((n, block), generator=g, device=device,
                                    dtype=torch.float64))[0]
    for _ in range(iters):
        V = torch.linalg.qr(Mv(V) + V)[0]      # M + I: spectrum in [0, 2]
    T = V.T @ Mv(V)
    return torch.linalg.eigvalsh(0.5 * (T + T.T)).flip(0)   # descending


def check(W: torch.Tensor, X0: torch.Tensor, block: int = 16,
          iters: int = 300) -> dict:
    deg = torch.sum(W, 1)
    dinv = 1.0 / torch.sqrt(torch.clamp_min(deg, 1e-300))

    def Mv(V):
        return dinv[:, None] * (W @ (dinv[:, None] * V))

    ritz = _ritz_values(Mv, W.shape[0], W.device, block, iters)
    resid, rank = 0.0, 0.0
    for k in range(X0.shape[1]):
        x = X0[:, k].double()
        v = x - torch.dot(deg, x) / torch.sum(deg)
        u = torch.sqrt(deg) * v
        u = u / torch.linalg.norm(u)
        Mu = Mv(u[:, None])[:, 0]
        theta = float(torch.dot(u, Mu))
        resid = worst(resid, float(torch.linalg.norm(Mu - theta * u)))
        rank = worst(rank, float(ritz[k + 1]) - theta)
    return {"start_resid": resid, "start_rank": rank}
