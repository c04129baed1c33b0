"""Input affinities: perplexity-calibrated Gaussian neighbourhoods (SNE-style).

Port of `repro/core/affinities.py`.  Given data Y (N, D), compute per-point
conditional distributions

    p_{m|n} = exp(-beta_n ||y_n - y_m||^2) / sum_{m' != n} exp(-beta_n ...)

with beta_n found by bisection so that the entropy of P_n equals
log(perplexity).  The bisection runs on all rows of a chunk at once (60
fixed steps); rows are processed in chunks so that the temporaries stay
bounded at large N.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Affinities(NamedTuple):
    """Input-side weights for the generic objective.

    Wp: attractive weights (P for normalized models, W+ for EE).
    Wm: repulsive weights (all-ones off-diagonal in the paper's
        experiments).
    """

    Wp: torch.Tensor
    Wm: torch.Tensor


def sq_distances(Y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, exact zero diagonal."""
    r = torch.sum(Y * Y, dim=-1)
    D2 = r[:, None] + r[None, :] - 2.0 * (Y @ Y.T)
    return torch.clamp_min(D2, 0.0).fill_diagonal_(0.0)


def _entropy_probs(d2: torch.Tensor, beta: torch.Tensor, self_mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shannon entropy (nats) and probabilities of each row's conditional
    distribution; d2 (R, N), beta (R,), self_mask (R, N) marks the self
    entry of each row."""
    logits = (-beta[:, None] * d2).masked_fill(self_mask, -math.inf)
    logits = logits - torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits)             # exp(-inf) = 0 at the self entry
    p = e / torch.sum(e, dim=-1, keepdim=True)
    plogp = torch.where(p > 0, p * torch.log(torch.clamp_min(p, 1e-37)), 0.0)
    return -torch.sum(plogp, dim=-1), p


def calibrated_conditionals(D2: torch.Tensor, perplexity: float,
                            n_iter: int = 60,
                            chunk_rows: int = 2048) -> torch.Tensor:
    """Per-row bisection on beta so H(P_n) = log(perplexity).  Returns P
    (N, N), row-stochastic with zero diagonal.  `chunk_rows` rows are
    calibrated at a time."""
    n = D2.shape[0]
    target = torch.log(torch.tensor(perplexity, dtype=D2.dtype,
                                    device=D2.device))
    P = torch.empty_like(D2)
    cols = torch.arange(n, device=D2.device)
    for r0 in range(0, n, chunk_rows):
        d2 = D2[r0:r0 + chunk_rows]
        rows = torch.arange(r0, r0 + d2.shape[0], device=D2.device)
        self_mask = cols[None, :] == rows[:, None]
        lo = torch.zeros(d2.shape[0], dtype=D2.dtype, device=D2.device)
        hi = torch.full_like(lo, math.inf)
        beta = torch.ones_like(lo)
        for _ in range(n_iter):
            h, _ = _entropy_probs(d2, beta, self_mask)
            # entropy decreases in beta: too much entropy -> raise beta
            too_high = h > target
            lo = torch.where(too_high, beta, lo)
            hi = torch.where(too_high, hi, beta)
            beta = torch.where(torch.isinf(hi), beta * 2.0, 0.5 * (lo + hi))
        P[r0:r0 + d2.shape[0]] = _entropy_probs(d2, beta, self_mask)[1]
    return P


def sne_affinities(Y: torch.Tensor, perplexity: float = 30.0) -> torch.Tensor:
    """Symmetric joint P (sums to 1, zero diagonal) from data Y."""
    return sne_affinities_from_d2(sq_distances(Y), perplexity)


def sne_affinities_from_d2(D2: torch.Tensor,
                           perplexity: float = 30.0) -> torch.Tensor:
    """The joint P = (P_cond + P_cond^T) / 2N of a squared-distance matrix."""
    P_cond = calibrated_conditionals(D2, perplexity)
    return (P_cond + P_cond.T) / (2.0 * D2.shape[0])


def make_affinities(Y: torch.Tensor, perplexity: float = 30.0,
                    model: str = "ee") -> Affinities:
    """Build (Wp, Wm) for a given model family.

    Normalized models (s-SNE / t-SNE): Wp = joint P = (P_cond + P_cond^T)/2N,
    which sums to 1 over all pairs; Wm = 1 off-diagonal.

    EE-family (ee / tee / epan): Wp = (P_cond + P_cond^T)/2, without the 1/N
    joint normalization, so row degrees are ~1; Wm = 1 off-diagonal.
    """
    n = Y.shape[0]
    P_cond = calibrated_conditionals(sq_distances(Y), perplexity)
    Wp = P_cond + P_cond.T
    Wp = Wp / (2.0 * n) if model in ("ssne", "tsne") else 0.5 * Wp
    Wm = torch.ones_like(Wp).fill_diagonal_(0.0)
    return Affinities(Wp=Wp, Wm=Wm)
