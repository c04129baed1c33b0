"""The dense single-device objective of the fit engine, and its minimizer.

Port of `DenseObjective`, its fused `_step`, `MinimizeResult` and
`_minimize` from `repro/core/minimize.py` (the deprecated `minimize` shim
is not ported: `repro_torch.api.Embedding` runs the same glue).  One step
is direction -> initial trial step -> Armijo backtracking -> update ->
energy and gradient at the new point, with the reference's alpha0 policy
and max_rel_move cap, all in float32 tensors.  The reference jits the whole
step into one XLA program; here it runs eagerly, and the line search reads
one flag per trial back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_storage, to_storage

from .affinities import Affinities
from .linesearch import LSConfig, backtracking
from .objectives import energy, energy_and_grad


@dataclasses.dataclass
class MinimizeResult:
    X: torch.Tensor
    energies: np.ndarray      # E_k, k = 0..n_iters (includes E_0)
    grad_norms: np.ndarray
    step_sizes: np.ndarray
    times: np.ndarray         # cumulative wall-clock seconds at each iterate
    n_fevals: np.ndarray      # cumulative energy evaluations
    n_iters: int
    converged: bool
    setup_time: float         # strategy init (e.g. Cholesky factorization)
    strategy_state: Any = None


def _step(strategy, kind: str, ls_cfg: LSConfig, X, E, G, state, alpha_prev,
          aff: Affinities, kernel_aff: Affinities, lam, impl: dict):
    """One fused iteration.  `aff` feeds the direction, `kernel_aff` (the
    same weights in the kernel's storage dtype) the energy evaluations."""
    P, state = strategy.direction(state, X, G, aff, kind, lam)
    if ls_cfg.init_step == "adaptive":
        alpha0 = alpha_prev
    elif ls_cfg.init_step == "adaptive_grow":
        alpha0 = torch.clamp_max(alpha_prev / ls_cfg.rho, 1.0)
    else:
        alpha0 = torch.ones_like(alpha_prev)
    if ls_cfg.max_rel_move is not None:
        xc = X - torch.mean(X, dim=0, keepdim=True)
        scale = torch.sqrt(torch.mean(xc * xc)) + 1e-3
        p_rms = torch.sqrt(torch.mean(P * P)) + 1e-30
        alpha0 = torch.minimum(alpha0, ls_cfg.max_rel_move * scale / p_rms)
    ls = backtracking(lambda Xn: energy(Xn, kernel_aff, kind, lam, **impl),
                      X, E, G, P, alpha0, ls_cfg)
    X_new = X + ls.alpha * P
    E_new, G_new = energy_and_grad(X_new, kernel_aff, kind, lam, **impl)
    return X_new, E_new, G_new, state, ls.alpha, ls.n_evals + 1


@dataclasses.dataclass
class DenseObjective:
    """Dense single-device backend of the engine's Objective protocol.

    Deterministic (`key` is ignored).  `impl` holds the `kernels.ops`
    dispatch kwargs (e.g. ``{"impl": "torch", "storage_dtype":
    "bfloat16"}``).  With bfloat16 storage the affinities are rounded to
    bfloat16 once here, so that no step converts the N x N matrices again;
    the strategies still see the float32 affinities.
    """

    aff: Affinities
    kind: str
    lam: torch.Tensor
    strategy: Any
    ls_cfg: LSConfig
    X0: torch.Tensor
    impl: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        storage = resolve_storage(self.impl.get("storage_dtype"))
        self._kernel_aff = Affinities(to_storage(self.aff.Wp, storage),
                                      to_storage(self.aff.Wm, storage))

    def energy_and_grad(self, X, key=None):
        return energy_and_grad(X, self._kernel_aff, self.kind, self.lam,
                               **self.impl)

    def energy(self, X, key=None):
        return energy(X, self._kernel_aff, self.kind, self.lam, **self.impl)

    def make_direction_solver(self):
        def solve(state, X, G):
            return self.strategy.direction(state, X, G, self.aff, self.kind,
                                           self.lam)

        # strategy.init may factor a Cholesky: this is the setup cost
        state0 = self.strategy.init(self.X0, self.aff, self.kind, self.lam)
        return solve, state0

    def make_fused_step(self):
        def step(X, E, G, state, alpha_prev):
            return _step(self.strategy, self.kind, self.ls_cfg, X, E, G,
                         state, alpha_prev, self.aff, self._kernel_aff,
                         self.lam, self.impl)

        return step


def _minimize(
    X0: torch.Tensor,
    aff: Affinities,
    kind: str,
    lam,
    strategy,
    max_iters: int = 500,
    tol: float = 1e-7,
    ls_cfg: LSConfig = LSConfig(),
    callback: Callable[..., None] | None = None,
    max_seconds: float | None = None,
) -> MinimizeResult:
    """Minimize E(X; lam) with the given search-direction strategy, on the
    device of X0 (the kernel path on CUDA).

    Stops on relative energy decrease < tol, on max_iters, or (for the
    paper's fixed-budget comparisons) on max_seconds of wall-clock.
    """
    # deferred: repro_torch.embed.engine imports repro_torch.core
    from repro_torch.embed.engine import LoopConfig, fit_loop

    lam = torch.as_tensor(lam, dtype=X0.dtype, device=X0.device)
    obj = DenseObjective(aff, kind, lam, strategy, ls_cfg, X0)
    res = fit_loop(
        obj, X0,
        LoopConfig(max_iters=max_iters, tol=tol, ls=ls_cfg,
                   convergence="raw", max_seconds=max_seconds),
        callback=callback,
    )
    return MinimizeResult(
        X=res.X,
        energies=res.energies,
        grad_norms=res.grad_norms,
        step_sizes=res.step_sizes,
        times=res.times,
        n_fevals=res.n_fevals,
        n_iters=res.n_iters,
        converged=res.converged,
        setup_time=res.setup_time,
        strategy_state=res.state,
    )
