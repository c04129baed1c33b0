"""The dense single-device objective of the fit engine.

Port of `DenseObjective` and its fused `_step` from
`repro/core/minimize.py`.  One step is direction -> initial trial step ->
Armijo backtracking -> update -> energy and gradient at the new point, with
the reference's alpha0 policy and max_rel_move cap, all in float32 tensors.
The reference jits the whole step into one XLA program; here it runs
eagerly, and the line search reads one flag per trial back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.ops import resolve_storage, to_storage

from .affinities import Affinities
from .linesearch import LSConfig, backtracking
from .objectives import energy, energy_and_grad


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
