"""Batched linear conjugate gradients for the SD- strategy (paper §2).

Port of `repro/core/cg.py`.  Solves B_i p_i = b_i for each embedding
dimension i independently (the SD- partial Hessian is block-diagonal with
one N x N block per dimension), under one stopping rule over all of
(d, N): ||r|| > tol ||b||.  Matches the paper's settings: exit at relative
tolerance eps = 0.1 or 50 iterations, warm-started from the previous outer
iteration's solution.  The reference runs the loop as one device
`while_loop`; here it is a host loop that reads one flag (the same test,
evaluated in float32 on the device) per CG iteration, so both stop after
the same iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor             # (d, N)
    n_iters: int
    rel_residual: torch.Tensor  # 0-d


def batched_cg(B: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
               tol: float = 0.1, maxiter: int = 50) -> CGResult:
    """B (d, N, N) pd blocks, b (d, N) right-hand sides, x0 (d, N) warm
    start."""
    def matvec(x):   # (d, N) -> (d, N), a batched GEMV
        return torch.bmm(B, x[:, :, None])[:, :, 0]

    b_norm = torch.clamp_min(torch.linalg.norm(b), 1e-30)
    x = x0
    r = b - matvec(x0)
    p = r
    rs = torch.sum(r * r)
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) > tol * b_norm):
        Bp = matvec(p)
        alpha = rs / torch.clamp_min(torch.sum(p * Bp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Bp
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = r + beta * p
        rs = rs_new
        k += 1
    return CGResult(x=x, n_iters=k,
                    rel_residual=torch.linalg.norm(r) / b_norm)
