"""Graph-Laplacian utilities (paper §1).

Port of `repro/core/laplacian.py`.  Given a symmetric nonnegative weight
matrix W (zero diagonal), its graph Laplacian is L = D - W with
D = diag(W @ 1); L is psd.  Everything here works on dense (N, N) tensors;
the paper's kappa-nearest-neighbour sparsity is represented by exact zeros.
"""
from __future__ import annotations

import torch


def zero_diagonal(W: torch.Tensor) -> torch.Tensor:
    return W.clone().fill_diagonal_(0.0)


def degree(W: torch.Tensor) -> torch.Tensor:
    """Degree vector d_n = sum_m w_nm."""
    return torch.sum(W, dim=-1)


def laplacian(W: torch.Tensor) -> torch.Tensor:
    """Dense graph Laplacian L = D - W."""
    return torch.diag(degree(W)) - W


def laplacian_matmul(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """L(W) @ X without forming L: D X - W X.  X is (N, d)."""
    return degree(W)[:, None] * X - W @ X


def symmetrize(W: torch.Tensor, mode: str = "avg") -> torch.Tensor:
    """Make W symmetric; `avg` (paper default) or `max` (kNN graphs)."""
    if mode == "avg":
        return 0.5 * (W + W.T)
    if mode == "max":
        return torch.maximum(W, W.T)
    raise ValueError(f"unknown symmetrize mode {mode!r}")


def knn_sparsify(W: torch.Tensor, kappa: int, sym: str = "max") -> torch.Tensor:
    """Keep the kappa largest entries per row of W (the paper's kappa knob).

    kappa >= N-1 returns W unchanged; kappa <= 0 keeps nothing.  See
    `sparsified_attractive_matrix` for how the paper uses it."""
    n = W.shape[-1]
    if kappa >= n - 1:
        return W
    if kappa <= 0:
        return torch.zeros_like(W)
    # threshold per row at the kappa-th largest value
    thresh = torch.topk(W, kappa, dim=-1).values[:, kappa - 1]
    Wk = torch.where(W >= thresh[:, None], W, 0.0)
    return zero_diagonal(symmetrize(Wk, sym))


def sparsified_attractive_matrix(Wp: torch.Tensor, kappa: int) -> torch.Tensor:
    """The paper's SD family over kappa: B ~ D+ - sparsify(W+, kappa).

    The degree D+ is always that of the full W+, so kappa = N gives the
    full L+ (pure spectral direction) and kappa = 0 gives D+ (the FP
    method).  The result is psd: L(W_kappa) + diag(residual degrees >= 0).
    """
    d_full = degree(Wp)
    Wk = knn_sparsify(Wp, kappa)
    # clip: `max` symmetrization may add mass; keep the matrix diag-dominant
    resid = torch.clamp_min(d_full - degree(Wk), 0.0)
    return torch.diag(degree(Wk) + resid) - Wk
