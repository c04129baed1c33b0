"""The spectral direction on the sparse backend in float64: Jacobi-
preconditioned CG on B P = -G with B = 4 L(W+) + mu I, mu = max(1e-10 min
diag, mu_scale mean diag) of 4 D+, warm-started from the previous
direction, stopping when ||r|| <= tol ||G|| or after `maxiter` iterations
(the rule is tested before each iteration)."""
from __future__ import annotations

import torch

from reference import graph_ops


class Direction:
    #: the line search's first trial step after an SD direction
    INITIAL_STEP = "adaptive_grow"

    def __init__(self, W: graph_ops.SymGraph, spec: dict):
        self.W = W
        bd = 4.0 * W.deg
        self.mu = torch.maximum(1e-10 * torch.min(bd),
                                float(spec.get("mu_scale", 1e-5))
                                * torch.mean(bd))
        self.inv_diag = 1.0 / (bd + self.mu)
        self.tol = float(spec["cg_tol"])
        self.maxiter = int(spec["cg_maxiter"])
        self.prev = None
        self.iters: list[int] = []

    def matvec(self, V):
        return 4.0 * self.W.lap(V) + self.mu * V

    def __call__(self, X, G):
        B = -G
        x = torch.zeros_like(G) if self.prev is None else self.prev
        b_norm = torch.clamp_min(torch.linalg.norm(B), 1e-30)
        r = B - self.matvec(x)
        p = self.inv_diag[:, None] * r
        rz = torch.sum(r * p)
        k = 0
        while k < self.maxiter and float(torch.linalg.norm(r)) > self.tol * float(b_norm):
            Ap = self.matvec(p)
            alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.inv_diag[:, None] * r
            rz_new = torch.sum(r * z)
            p = z + (rz_new / torch.clamp_min(rz, 1e-30)) * p
            rz = rz_new
            k += 1
        self.prev = x
        self.iters.append(k)
        return x
