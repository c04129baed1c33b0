"""Perplexity-calibrated affinities in float64, row block by row block.

The paper's input side (SNE-style Gaussian neighbourhoods): for every
point n, beta_n is bisected (60 steps, from 1, doubling until bracketed)
so that the entropy of p_{.|n} equals log(perplexity); then
W+ = (P_cond + P_cond^T) / 2 for the EE family, or / 2N for s-SNE and
t-SNE.  The repulsive weights are 1 off the diagonal and never stored."""
from __future__ import annotations

import math

import torch

NORMALIZED = ("ssne", "tsne")


def sq_distances_rows(Y: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
    """Squared distances of rows r0:r1 of Y to every row, float64."""
    Yb = Y[r0:r1]
    d2 = (torch.sum(Yb * Yb, 1)[:, None] + torch.sum(Y * Y, 1)[None, :]
          - 2.0 * (Yb @ Y.T))
    return d2.clamp_min_(0.0)


def conditionals(Y: torch.Tensor, perplexity: float, n_iter: int = 60,
                 block: int = 1024) -> torch.Tensor:
    """P_cond (N, N) float64, each row a distribution with zero diagonal."""
    Y = Y.double()
    n = Y.shape[0]
    P = torch.empty((n, n), dtype=torch.float64, device=Y.device)
    target = math.log(perplexity)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        d2 = sq_distances_rows(Y, r0, r1)
        rows = torch.arange(r1 - r0, device=Y.device)
        d2[rows, r0 + rows] = math.inf               # no self-affinity
        lo = torch.zeros(r1 - r0, dtype=torch.float64, device=Y.device)
        hi = torch.full_like(lo, math.inf)
        beta = torch.ones_like(lo)
        for _ in range(n_iter):
            h = _entropy(d2, beta)[0]
            too_high = h > target
            lo = torch.where(too_high, beta, lo)
            hi = torch.where(too_high, hi, beta)
            beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
        P[r0:r1] = _entropy(d2, beta)[1]
    return P


def _entropy(d2: torch.Tensor, beta: torch.Tensor):
    logits = -beta[:, None] * d2
    logits = logits - torch.amax(logits, 1, keepdim=True)
    e = torch.exp(logits)
    p = e / torch.sum(e, 1, keepdim=True)
    plogp = torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-300)),
                        0.0)
    return -torch.sum(plogp, 1), p


def attractive(Y: torch.Tensor, perplexity: float, kind: str) -> torch.Tensor:
    """W+ (N, N) float64, symmetric, zero diagonal."""
    P = conditionals(Y, perplexity)
    W = P + P.T
    del P
    n = W.shape[0]
    return W.mul_(1.0 / (2.0 * n) if kind in NORMALIZED else 0.5)
