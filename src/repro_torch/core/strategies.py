"""Partial-Hessian search-direction strategies (paper §2).

Port of `GD`, `FP` and `SD` from `repro/core/strategies.py`.  Every
strategy defines a pd matrix B_k and the direction p_k = -B_k^{-1} g_k:

  GD      B = I                              (gradient descent)
  FP      B = 4 D+ (x) I_d                   (diagonal fixed-point iteration)
  SD      B = 4 L+_kappa (x) I_d + mu I      (the spectral direction;
                                              Cholesky factor cached at init)

The kappa knob sparsifies L+ through the k-NN graph as in the paper: kappa
>= N-1 is the full spectral direction, kappa = 0 degenerates to FP.
Strategy objects are frozen; per-run tensors (the Cholesky factor) live in
the `state` dict returned by `init`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .affinities import Affinities
from .laplacian import degree, sparsified_attractive_matrix
from .objectives import attractive_weights

State = Any


def _jitter(Bdiag_min: torch.Tensor, Bdiag_mean: torch.Tensor) -> torch.Tensor:
    """Paper's mu = 1e-10 min(L+_nn), floored relative to the mean degree
    for float32 robustness (the paper ran double precision)."""
    return torch.maximum(1e-10 * Bdiag_min, 1e-6 * Bdiag_mean)


@dataclasses.dataclass(frozen=True)
class GD:
    name: str = "GD"

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        return ()

    def direction(self, state, X, G, aff, kind, lam):
        return -G, state


@dataclasses.dataclass(frozen=True)
class FP:
    """Diagonal fixed-point method: B = 4 D+ (Carreira-Perpinan 2010)."""

    name: str = "FP"

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        dp = degree(attractive_weights(aff, kind))
        mu = _jitter(torch.min(dp), torch.mean(dp))
        return {"inv_diag": 1.0 / (4.0 * dp + mu)}

    def direction(self, state, X, G, aff, kind, lam):
        return -state["inv_diag"][:, None] * G, state


@dataclasses.dataclass(frozen=True)
class SD:
    """The spectral direction (the paper's headline strategy).

    B = 4 (D+ - W+_kappa) + mu I is constant; its Cholesky factor is
    computed once in `init`, and every iteration costs two triangular
    solves (O(N^2 d)) plus `refine` steps of iterative refinement.

    float32 adaptations (the paper ran double precision): mu = mu_scale *
    mean(diag B) (`mu_scale=None` gives the paper's 1e-10 min(L+_nn)), and
    the line search caps the first trial displacement (LSConfig.
    max_rel_move).
    """

    name: str = "SD"
    kappa: int = -1   # -1 => no sparsification (kappa = N in paper notation)
    mu_scale: float | None = 1e-5
    refine: int = 1

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        Wp = attractive_weights(aff, kind)
        n = Wp.shape[0]
        kappa = self.kappa if self.kappa >= 0 else n
        B = 4.0 * sparsified_attractive_matrix(Wp, kappa)
        bd = torch.diagonal(B)
        if self.mu_scale is None:
            mu = 1e-10 * torch.min(bd)          # paper's setting
        else:
            mu = torch.maximum(1e-10 * torch.min(bd),
                               self.mu_scale * torch.mean(bd))
        B.diagonal().add_(mu)                   # B + mu I, in place
        return {"chol": torch.linalg.cholesky(B), "B": B}   # lower factor

    def direction(self, state, X, G, aff, kind, lam):
        R = state["chol"]
        P = -torch.cholesky_solve(G, R)
        for _ in range(self.refine):
            resid = -G - state["B"] @ P
            P = P + torch.cholesky_solve(resid, R)
        return P, state
