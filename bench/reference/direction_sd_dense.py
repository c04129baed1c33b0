"""The spectral direction on the dense backend, solved exactly in float64.

B = 4 (D+ - W+_kappa) + mu I, where W+_kappa keeps the kappa largest
weights of every row of W+ (the union of both directions, by the larger
weight), D+ stays the degree of the full W+ (the residual degree goes on
the diagonal) and mu = max(1e-10 min diag B, mu_scale mean diag B); the
direction is P = -B^{-1} G by one Cholesky factor; `matvec` applies B."""
from __future__ import annotations

import torch


def system(W: torch.Tensor, kappa: int, mu_scale: float) -> torch.Tensor:
    n = W.shape[0]
    deg_full = torch.sum(W, 1)
    if 0 <= kappa < n - 1:
        if kappa == 0:
            Wk = torch.zeros_like(W)
        else:
            thresh = torch.topk(W, kappa, dim=1).values[:, kappa - 1]
            Wk = torch.where(W >= thresh[:, None], W, 0.0)
            Wk = torch.maximum(Wk, Wk.T)
            Wk.fill_diagonal_(0.0)
    else:
        Wk = W.clone()
    deg_k = torch.sum(Wk, 1)
    resid = torch.clamp_min(deg_full - deg_k, 0.0)
    B = Wk.neg_()
    B.diagonal().add_(deg_k + resid)
    B.mul_(4.0)
    bd = torch.diagonal(B)
    mu = torch.maximum(1e-10 * torch.min(bd), mu_scale * torch.mean(bd))
    B.diagonal().add_(mu)
    return B


class Direction:
    #: the line search's first trial step after an SD direction
    INITIAL_STEP = "adaptive_grow"

    def __init__(self, W: torch.Tensor, spec: dict):
        self.B = system(W, int(spec.get("strategy_opts", {}).get("kappa", -1)),
                        float(spec.get("mu_scale", 1e-5)))
        self.L = torch.linalg.cholesky(self.B)

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        return self.B @ V

    def __call__(self, X: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
        return -torch.cholesky_solve(G, self.L)
