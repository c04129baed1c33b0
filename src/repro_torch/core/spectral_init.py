"""Spectral (Laplacian-eigenmaps) initialization — the lambda = 0 solution.

Port of `repro/core/spectral_init.py`: the bottom nontrivial generalized
eigenvectors of (L+, D+), the standard initializer of the paper's methods.
"""
from __future__ import annotations

import torch

from .laplacian import degree


def laplacian_eigenmaps(Wp: torch.Tensor, d: int = 2) -> torch.Tensor:
    """Bottom-d nontrivial eigenvectors of the normalized Laplacian.

    Solves L u = mu D u via the symmetric form I - D^{-1/2} W D^{-1/2};
    returns X = D^{-1/2} U (N, d), centred and scaled to unit std per
    dimension.  Each column's sign is whatever `torch.linalg.eigh` gives.
    """
    dg = torch.clamp_min(degree(Wp), 1e-12)
    dinv = 1.0 / torch.sqrt(dg)
    M = dinv[:, None] * Wp * dinv[None, :]
    # the top d+1 eigenvectors of M are the bottom ones of I - M; the very
    # top one is the trivial constant direction and is dropped
    _, vecs = torch.linalg.eigh(0.5 * (M + M.T))
    U = vecs[:, -(d + 1):-1].flip(-1)
    X = dinv[:, None] * U
    X = X - torch.mean(X, dim=0, keepdim=True)
    return X / torch.clamp_min(torch.std(X, dim=0, correction=0, keepdim=True),
                               1e-12)
