"""The sparse backend's spectral start in float64: a frozen copy of the
block power iteration.  The start block (N, d + 1 + oversample) is drawn
on the CPU from `seed` (float32 normal draws), orthonormalised, and
iterated `n_iters` times as V <- orth((M + I) V) for M = D^-1/2 W+ D^-1/2
(D the degrees of W+); a Rayleigh-Ritz step orders the block, the top
vector (the trivial one) is dropped, the next d are mapped back through
D^-1/2, centred, scaled to unit deviation and by 0.1."""
from __future__ import annotations

import torch

from reference import graph_ops


def start(W: graph_ops.SymGraph, d: int, seed: int, n_iters: int = 300,
          oversample: int = 6) -> torch.Tensor:
    n = W.deg.shape[0]
    dinv = 1.0 / torch.sqrt(torch.clamp_min(W.deg, 1e-12))

    def Mv(V):
        return dinv[:, None] * W.matvec(dinv[:, None] * V)

    cols = min(d + 1 + oversample, n)
    g = torch.Generator().manual_seed(seed)
    V0 = torch.randn((n, cols), generator=g, dtype=torch.float32)
    V = torch.linalg.qr(V0.double().to(W.deg.device))[0]
    for _ in range(n_iters):
        V = torch.linalg.qr(Mv(V) + V)[0]
    T = V.T @ Mv(V)
    S = torch.linalg.eigh(0.5 * (T + T.T))[1]
    U = V @ S.flip(-1)
    X = dinv[:, None] * U[:, 1:d + 1]
    X = X - torch.mean(X, 0, keepdim=True)
    return 0.1 * X / torch.std(X, 0, correction=0, keepdim=True)
