"""The paper's backtracking line search (Armijo, c1 = 1e-4, rho = 0.5, at
most 30 trials), with the initial trial step of the strategy ('one', or
'adaptive_grow': the previous step / rho, at most 1) capped so that the
trial displacement's rms is at most 10 (rms(X - mean X) + 1e-3).

`dense_step` is the dense backend's step: the trials back off from the
initial step and, when none passes, the last trial is taken.
`sampled_step` is the sparse backend's: when none passes, the step shrinks
once more and is taken there."""
from __future__ import annotations

import math

import torch

C1, RHO, MAX_BACKTRACKS, MAX_REL_MOVE = 1e-4, 0.5, 30, 10.0


def initial_step(X: torch.Tensor, P: torch.Tensor, alpha_prev: float,
                 policy: str) -> float:
    if policy == "adaptive_grow":
        a0 = min(alpha_prev / RHO, 1.0)
    elif policy == "adaptive":
        a0 = alpha_prev
    else:
        a0 = 1.0
    xc = X - torch.mean(X, 0, keepdim=True)
    scale = math.sqrt(float(torch.mean(xc * xc))) + 1e-3
    p_rms = math.sqrt(float(torch.mean(P * P))) + 1e-30
    return min(a0, MAX_REL_MOVE * scale / p_rms)


def _search(energy, X, e0, G, P, alpha):
    gtp = float(torch.sum(G * P))
    for k in range(1, MAX_BACKTRACKS + 1):
        e_new = energy(X + alpha * P)
        if e_new <= e0 + C1 * alpha * gtp:
            return alpha, e_new, k, True
        if k < MAX_BACKTRACKS:
            alpha *= RHO
    return alpha, e_new, MAX_BACKTRACKS, False


def dense_step(energy, X, e0, G, P, alpha0):
    """(alpha, E(X + alpha P), evaluations)."""
    alpha, e_new, k, _ = _search(energy, X, e0, G, P, alpha0)
    return alpha, e_new, k


def sampled_step(energy, X, e0, G, P, alpha0):
    alpha, e_new, k, ok = _search(energy, X, e0, G, P, alpha0)
    if not ok:
        alpha *= RHO
        e_new = energy(X + alpha * P)
        k += 1
    return alpha, e_new, k
