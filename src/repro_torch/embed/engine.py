"""The fit engine: one optimization loop over a fused-step objective.

Port of `repro/embed/engine.py` for the dense fused-step path.  `fit_loop`
owns the convergence test (raw relative energy decrease), the wall-clock
budget, callbacks, and the per-iteration traces (energy, gradient norm,
accepted step, cumulative wall-clock and energy evaluations).

An objective provides

    energy_and_grad(X, key) -> (E, G)
    make_direction_solver() -> (solve, state0)   state0 is the setup cost
    make_fused_step()       -> step(X, E, G, state, alpha)
                               -> (X, E, G, state, alpha, n_evals)

Not in this port yet: checkpoint/resume, stochastic objectives with EMA
convergence, and telemetry.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.linesearch import LSConfig


@runtime_checkable
class Objective(Protocol):
    def energy_and_grad(self, X: torch.Tensor, key) -> tuple: ...

    def make_direction_solver(self): ...

    def make_fused_step(self): ...


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    max_iters: int = 200
    tol: float = 1e-7
    ls: LSConfig = LSConfig(init_step="adaptive_grow")
    max_seconds: float | None = None


@dataclasses.dataclass
class EngineResult:
    X: torch.Tensor
    energies: np.ndarray      # E_k, k = 0..n_iters (includes E_0)
    grad_norms: np.ndarray
    step_sizes: np.ndarray
    times: np.ndarray         # cumulative wall-clock seconds at each iterate
    n_fevals: np.ndarray      # cumulative energy evaluations
    n_iters: int
    converged: bool
    setup_time: float         # direction-solver init (e.g. Cholesky)
    state: Any = None         # final direction-solver state
    diagnostics: list[dict] | None = None   # per-iteration table, when a
                                            # callback listens
    phase_times: dict = dataclasses.field(default_factory=dict)
    # seconds of the problem set-up before the loop (affinities, spectral
    # init), filled in by the backend


def _sync(X: torch.Tensor) -> None:
    if X.is_cuda:
        torch.cuda.synchronize(X.device)


def _host_scalars(*values: torch.Tensor) -> list[float]:
    """One batched device-to-host transfer for a few 0-d tensors."""
    return torch.stack([v.detach().reshape(()).to(torch.float64)
                        for v in values]).cpu().tolist()


def fit_loop(objective: Objective, X0: torch.Tensor,
             cfg: LoopConfig = LoopConfig(),
             callback: Callable[[int, torch.Tensor, float, dict], None]
             | None = None) -> EngineResult:
    """Run the optimization loop to convergence or budget.

    Stops on relative energy decrease < tol, on max_iters, or on
    max_seconds of wall-clock (the paper's fixed-budget comparisons).
    `callback(it, X, e, diagnostics)` sees each iteration's diagnostics
    dict (energy, gradient norm, accepted step, evaluations, times).
    """
    t0 = time.perf_counter()
    _, state = objective.make_direction_solver()
    _sync(X0)
    setup_time = time.perf_counter() - t0
    step = objective.make_fused_step()

    X = X0
    alpha = torch.ones((), dtype=X0.dtype, device=X0.device)
    E, G = objective.energy_and_grad(X, None)
    e_host, g_host = _host_scalars(E, torch.linalg.norm(G))
    energies = [e_host]
    gnorms = [g_host]
    steps: list[float] = []
    times = [0.0]
    fevals = [1]

    converged = False
    diags: list[dict] = []
    t_loop = time.perf_counter()
    it = 0
    for it in range(1, cfg.max_iters + 1):
        X, E, G, state, alpha, n_ev = step(X, E, G, state, alpha)
        e_rec, g_host, alpha_host = _host_scalars(E, torch.linalg.norm(G),
                                                  alpha)
        now = time.perf_counter() - t_loop
        energies.append(e_rec)
        gnorms.append(g_host)
        steps.append(alpha_host)
        times.append(now)
        fevals.append(fevals[-1] + n_ev)
        if callback is not None:
            diag = {"it": it, "energy": e_rec, "grad_norm": g_host,
                    "alpha": alpha_host, "n_evals": n_ev, "t": now,
                    "iter_s": now - times[-2]}
            diags.append(diag)
            callback(it, X, e_rec, diag)
        rel = abs(energies[-2] - e_rec) / max(abs(e_rec), 1e-30)
        if rel < cfg.tol:
            converged = True
            break
        if cfg.max_seconds is not None and now > cfg.max_seconds:
            break

    return EngineResult(
        X=X,
        energies=np.asarray(energies),
        grad_norms=np.asarray(gnorms),
        step_sizes=np.asarray(steps),
        times=np.asarray(times),
        n_fevals=np.asarray(fevals),
        n_iters=it,
        converged=converged,
        setup_time=setup_time,
        state=state,
        diagnostics=diags if callback is not None else None,
    )


def make_loop_config(spec, ls: LSConfig) -> LoopConfig:
    """LoopConfig from an EmbedSpec (port of `repro/embed/trainer.py::
    make_loop_config`)."""
    return LoopConfig(max_iters=spec.max_iters, tol=spec.tol, ls=ls,
                      max_seconds=spec.max_seconds)
