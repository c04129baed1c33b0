"""Homotopy optimization over lambda (paper §3.1, Fig. 3).

Port of `repro/core/homotopy.py`.  Start near lambda = 0 where E is convex
(dominated by the spectral E+) and follow the minimum path X(lambda) to the
target lambda, warm-starting each stage from the previous solution.  Slower
than direct minimization but finds deeper minima (Carreira-Perpinan 2010).
Works with every strategy.  Each stage is one `_minimize`, which runs
`strategy.init` again (for SD, its Cholesky factor), as the reference's
code does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .affinities import Affinities
from .linesearch import LSConfig
from .minimize import MinimizeResult, _minimize


@dataclasses.dataclass
class HomotopyResult:
    X: torch.Tensor
    lambdas: np.ndarray
    energies: np.ndarray          # final E at each lambda
    iters_per_lambda: np.ndarray
    fevals_per_lambda: np.ndarray
    time_per_lambda: np.ndarray
    results: list[MinimizeResult]


def homotopy_path(
    X0: torch.Tensor,
    aff: Affinities,
    kind: str,
    strategy,
    lam_final: float,
    n_stages: int = 50,
    lam_start: float = 1e-4,
    tol: float = 1e-6,
    max_iters: int = 10_000,
    ls_cfg: LSConfig = LSConfig(),
) -> HomotopyResult:
    """Paper settings: 50 log-spaced lambdas from 1e-4 to the target, inner
    tolerance 1e-6 relative decrease or 1e4 iterations."""
    lambdas = np.logspace(np.log10(lam_start), np.log10(lam_final), n_stages)
    X = X0
    results: list[MinimizeResult] = []
    for lam in lambdas:
        res = _minimize(
            X, aff, kind, torch.tensor(lam, dtype=X0.dtype, device=X0.device),
            strategy, max_iters=max_iters, tol=tol, ls_cfg=ls_cfg,
        )
        X = res.X
        results.append(res)
    return HomotopyResult(
        X=X,
        lambdas=lambdas,
        energies=np.asarray([r.energies[-1] for r in results]),
        iters_per_lambda=np.asarray([r.n_iters for r in results]),
        fevals_per_lambda=np.asarray([r.n_fevals[-1] for r in results]),
        time_per_lambda=np.asarray([r.times[-1] + r.setup_time
                                    for r in results]),
        results=results,
    )
