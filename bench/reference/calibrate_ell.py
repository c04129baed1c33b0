"""Perplexity calibration over each row's k candidates in float64 (60
bisection steps on beta, as the dense calibration), giving the directed
weights A of the sparse backend: P_cond over the valid slots (the point
itself is not valid), divided by N for s-SNE and t-SNE.  Invalid slots get
the point's own index and weight 0."""
from __future__ import annotations

import math

import torch

NORMALIZED = ("ssne", "tsne")


def _entropy(d2, beta, valid):
    logits = torch.where(valid, -beta[:, None] * d2, -torch.inf)
    logits = logits - torch.amax(logits, 1, keepdim=True)
    e = torch.where(valid, torch.exp(logits), 0.0)
    p = e / torch.sum(e, 1, keepdim=True)
    plogp = torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-300)),
                        0.0)
    return -torch.sum(plogp, 1), p


def weights(d2: torch.Tensor, idx: torch.Tensor, perplexity: float,
            kind: str, n_iter: int = 60):
    n = d2.shape[0]
    self_col = torch.arange(n, device=idx.device)[:, None]
    valid = idx != self_col
    target = math.log(perplexity)
    lo = torch.zeros(n, dtype=torch.float64, device=d2.device)
    hi = torch.full_like(lo, math.inf)
    beta = torch.ones_like(lo)
    for _ in range(n_iter):
        h = _entropy(d2, beta, valid)[0]
        too_high = h > target
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
    w = _entropy(d2, beta, valid)[1]
    if kind in NORMALIZED:
        w = w / n
    return torch.where(valid, idx, self_col), torch.where(valid, w, 0.0)
