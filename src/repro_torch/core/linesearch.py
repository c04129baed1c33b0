"""Backtracking line search (first Wolfe / Armijo condition), paper §3.

Port of `repro/core/linesearch.py`.  The reference runs the search inside
one XLA program; here it is a host loop that reads one flag from the device
per trial.  The step, the trial energies and the Armijo test stay float32
tensors, so the accepted step is the one the reference accepts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.analysis.guards import explicit_read


@dataclasses.dataclass(frozen=True)
class LSConfig:
    c1: float = 1e-4            # Armijo sufficient-decrease constant
    rho: float = 0.5            # backtracking factor
    max_backtracks: int = 30
    # Initial trial step policy (paper §3):
    #   'one'           always try the natural alpha = 1 (default)
    #   'adaptive'      previous accepted step
    #   'adaptive_grow' previous step / rho, capped at 1
    init_step: str = "one"
    # Trust cap on the first trial displacement: alpha0 is clamped so that
    # rms(alpha0 * P) <= max_rel_move * (rms(X - mean(X)) + 1e-3).  None
    # disables.
    max_rel_move: float | None = 10.0

    def __post_init__(self):
        if self.init_step not in ("one", "adaptive", "adaptive_grow"):
            raise ValueError(f"unknown init_step {self.init_step!r}")


class LSResult(NamedTuple):
    alpha: torch.Tensor   # accepted step (0-d)
    e_new: torch.Tensor   # E(x + alpha p)
    n_evals: int          # number of energy evaluations
    success: bool         # Armijo satisfied (else: the backtrack cap hit)


def _accepted(e_new: torch.Tensor, e0: torch.Tensor, c1: float,
              alpha: torch.Tensor, gtp: torch.Tensor) -> bool:
    """The Armijo test, evaluated in float32 on the device; one flag read
    back to the host, a sanctioned read (the reference's loop condition;
    `analysis.guards.explicit_read`)."""
    ok = e_new <= e0 + c1 * alpha * gtp
    with explicit_read():
        return bool(ok)


def backtracking(energy_fn: Callable[[torch.Tensor], torch.Tensor],
                 X: torch.Tensor, e0: torch.Tensor, G: torch.Tensor,
                 P: torch.Tensor, alpha0: torch.Tensor,
                 cfg: LSConfig = LSConfig()) -> LSResult:
    """Find alpha with E(X + alpha P) <= E(X) + c1 alpha <G, P>."""
    gtp = torch.sum(G * P)
    alpha = alpha0
    e_new = energy_fn(X + alpha * P)
    k = 1
    ok = _accepted(e_new, e0, cfg.c1, alpha, gtp)
    while not ok and k < cfg.max_backtracks:
        alpha = alpha * cfg.rho
        e_new = energy_fn(X + alpha * P)
        k += 1
        ok = _accepted(e_new, e0, cfg.c1, alpha, gtp)
    return LSResult(alpha=alpha, e_new=e_new, n_evals=k, success=ok)
