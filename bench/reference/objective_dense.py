"""The embedding objective E(X) = E+(X) + lam E-(X) and its gradient in
float64, by row blocks, for every model family of the paper (with the
repulsive weights 1 off the diagonal):

    kind   attractive a   repulsive b   E+ terms          E- terms
    ee     W+             exp(-t)       W+ t              exp(-t)
    ssne   W+             exp(-t)       W+ t              exp(-t)
    tsne   W+ K           K^2           W+ log(1 + t)     K
    tee    W+             K^2           W+ t              K
    epan   W+             [t < 1]       W+ t              max(1 - t, 0)

with t = ||x_n - x_m||^2 and K = 1 / (1 + t).  The unnormalized kinds
take E = E+ + lam s, the normalized ones (ssne, tsne) E = E+ + lam log s,
with s the sum of the E- terms; the gradient is 4 (L(a) X - c L(b) X) with
c = lam (unnormalized) or lam / s (normalized), L the graph Laplacian."""
from __future__ import annotations

import math

import torch

NORMALIZED = ("ssne", "tsne")


def _pair_terms(kind: str, W: torch.Tensor, t: torch.Tensor, off: torch.Tensor):
    if kind in ("ee", "ssne"):
        b = torch.exp(-t) * off
        return W, b, W * t, b
    if kind == "tsne":
        K = 1.0 / (1.0 + t)
        return W * K, K * K * off, W * torch.log1p(t), K * off
    if kind == "tee":
        K = 1.0 / (1.0 + t)
        return W, K * K * off, W * t, K * off
    if kind == "epan":
        return (W, (t < 1.0).double() * off, W * t,
                torch.clamp_min(1.0 - t, 0.0) * off)
    raise ValueError(f"unknown kind {kind!r}")


def terms(X: torch.Tensor, W: torch.Tensor, kind: str, block: int = 1024):
    """(L(a) X, L(b) X, E+, s) in float64."""
    X = X.double()
    n = X.shape[0]
    la = torch.empty_like(X)
    lb = torch.empty_like(X)
    e_plus = torch.zeros((), dtype=torch.float64, device=X.device)
    s = torch.zeros_like(e_plus)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        diff = X[r0:r1, None, :] - X[None, :, :]
        t = torch.sum(diff * diff, -1)
        del diff
        off = torch.ones_like(t)
        rows = torch.arange(r1 - r0, device=X.device)
        off[rows, r0 + rows] = 0.0
        a, b, ep, sp = _pair_terms(kind, W[r0:r1].double(), t, off)
        la[r0:r1] = torch.sum(a, 1)[:, None] * X[r0:r1] - a @ X
        lb[r0:r1] = torch.sum(b, 1)[:, None] * X[r0:r1] - b @ X
        e_plus += torch.sum(ep)
        s += torch.sum(sp)
    return la, lb, e_plus, s


def energy_and_grad(X: torch.Tensor, W: torch.Tensor, kind: str, lam: float):
    la, lb, e_plus, s = terms(X, W, kind)
    if kind in NORMALIZED:
        return (float(e_plus + lam * torch.log(s)),
                4.0 * (la - (lam / s) * lb))
    return float(e_plus + lam * s), 4.0 * (la - lam * lb)


def energy(X: torch.Tensor, W: torch.Tensor, kind: str, lam: float) -> float:
    e = energy_and_grad(X, W, kind, lam)[0]
    return e if math.isfinite(e) else math.inf
