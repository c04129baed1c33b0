"""The generic embedding objective E(X; lam) = E+(X) + lam * E-(X) (paper §1).

Port of the dense half of `repro/core/objectives.py`.  Model families
(`kind`): 'ee' (elastic embedding), 'ssne' (symmetric SNE), 'tsne' (t-SNE),
'tee' (t-EE) and 'epan' (Epanechnikov EE).

Gradients are computed in the paper's Laplacian form, grad = 4 L(w) X,
through the fused pairwise contract (kernels/ops.py):

  unnormalized:  E = e_plus + lam*s          grad = 4 (L(a)X - lam   * L(b)X)
  normalized:    E = e_plus + lam*log(s)     grad = 4 (L(a)X - lam/s * L(b)X)

`direct_energy` is the textbook form, used only to check the Laplacian-form
gradient against autograd in the tests.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import KINDS, PairwiseTerms

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


def attractive_weights(aff: Affinities, kind: str) -> torch.Tensor:
    """Weights of the attractive (spectral) Hessian 4 L+ (x) I_d.

    For EE / s-SNE the attractive Hessian is exactly 4 L(W+).  For t-SNE it
    depends on X; as in the paper it is frozen at X = 0, which gives the same
    L(P) and keeps the cached Cholesky factor valid (likewise t-EE and
    Epanechnikov)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    return aff.Wp
