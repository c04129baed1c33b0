"""The fit engine: one optimization loop for every objective.

Port of `repro/embed/engine.py`.  `fit_loop` owns the convergence test
(raw relative energy decrease for deterministic objectives, an exponential
moving average for stochastic ones, where a raw test would fire on
sampling noise), the wall-clock budget, callbacks, and the per-iteration
traces (energy, gradient norm, accepted step, cumulative wall-clock and
energy evaluations).

An objective provides

    energy_and_grad(X, key) -> (E, G)
    energy(X, key)          -> E       line-search fast path
    make_direction_solver() -> (solve, state0)   state0 is the setup cost
                               solve(state, X, G) -> (P, state)

and may provide

    make_fused_step()  step(X, E, G, state, alpha)
                       -> (X, E, G, state, alpha, n_evals): the whole
                       direction / line search / update sequence (the dense
                       backend); without it the engine runs that sequence
                       itself on host floats (`initial_step`,
                       `host_backtrack`)
    stochastic         True: one draw key per iteration and EMA convergence;
                       the accepted energy is the line search's surrogate
    diagnostics()      host floats of the last step's solver diagnostics
                       (e.g. PCG iterations), read only when a callback
                       listens
    agree_elapsed(s)   the seconds the time budget (`max_seconds`) reads in
                       place of this process's own `s`: the sharded backend,
                       whose ranks each run this loop, returns the slowest
                       rank's, so that all stop on the same iteration

The draw key of iteration `it` is the pair (seed + 1, it), the counterpart
of the reference's `fold_in(PRNGKey(seed + 1), it)`; the initial evaluation
uses it = 0.  A deterministic objective gets key None.

Not in this port yet: checkpoint/resume and telemetry.
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
    """Duck-typed; see the module docstring for optional members."""

    def energy_and_grad(self, X: torch.Tensor, key) -> tuple: ...

    def energy(self, X: torch.Tensor, key) -> torch.Tensor: ...

    def make_direction_solver(self): ...


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    max_iters: int = 200
    tol: float = 1e-7
    ls: LSConfig = LSConfig(init_step="adaptive_grow")
    convergence: str = "auto"    # 'raw' | 'ema' | 'auto' (ema iff stochastic)
    ema_decay: float = 0.9
    seed: int = 0
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


def initial_step(X: torch.Tensor, P: torch.Tensor, alpha_prev: float,
                 ls: LSConfig) -> float:
    """Adaptive-grow initial trial step with the max-rel-move trust cap: the
    host-side mirror of the policy inside the dense fused step."""
    alpha0 = min(alpha_prev / ls.rho, 1.0)
    if ls.max_rel_move is not None:
        xc = X - torch.mean(X, dim=0, keepdim=True)
        scale, p_rms = _host_scalars(torch.sqrt(torch.mean(xc * xc)),
                                     torch.sqrt(torch.mean(P * P)))
        alpha0 = min(alpha0,
                     ls.max_rel_move * (scale + 1e-3) / (p_rms + 1e-30))
    return alpha0


def host_backtrack(energy_of: Callable[[torch.Tensor], float],
                   X: torch.Tensor, e0: float, G: torch.Tensor,
                   P: torch.Tensor, alpha0: float, ls: LSConfig
                   ) -> tuple[float, float, int]:
    """Armijo backtracking on host floats, one energy evaluation a trial.
    Returns the accepted (alpha, E(X + alpha P), n_evals); on backtrack
    exhaustion alpha shrinks once more and E is evaluated there."""
    gtp = float(torch.dot(G.reshape(-1), P.reshape(-1)))
    alpha = alpha0
    n_evals = 0
    for _ in range(ls.max_backtracks):
        e_new = energy_of(X + alpha * P)
        n_evals += 1
        if e_new <= e0 + ls.c1 * alpha * gtp:
            break
        alpha *= ls.rho
    else:
        e_new = energy_of(X + alpha * P)
        n_evals += 1
    return alpha, e_new, n_evals


def fit_loop(objective: Objective, X0: torch.Tensor,
             cfg: LoopConfig = LoopConfig(),
             callback: Callable[[int, torch.Tensor, float, dict], None]
             | None = None) -> EngineResult:
    """Run the optimization loop to convergence or budget.

    Stops on relative (raw or EMA) energy decrease < tol, on max_iters, or
    on max_seconds of wall-clock (the paper's fixed-budget comparisons).
    `callback(it, X, e, diagnostics)` sees each iteration's diagnostics
    dict (energy, gradient norm, accepted step, evaluations, times, and
    the objective's `diagnostics()`).
    """
    stochastic = bool(getattr(objective, "stochastic", False))
    conv = cfg.convergence
    if conv == "auto":
        conv = "ema" if stochastic else "raw"
    if conv not in ("raw", "ema"):
        raise ValueError(f"unknown convergence mode {conv!r}")
    obj_diag = getattr(objective, "diagnostics", None)
    agree_elapsed = getattr(objective, "agree_elapsed", lambda s: s)

    t0 = time.perf_counter()
    solve, state = objective.make_direction_solver()
    _sync(X0)
    setup_time = time.perf_counter() - t0
    make_fused = getattr(objective, "make_fused_step", None)
    fused_step = make_fused() if make_fused is not None else None

    X = X0
    # the fused step threads alpha as a device scalar, the host path as a
    # python float
    alpha = torch.ones((), dtype=X0.dtype, device=X0.device)
    alpha_host = 1.0
    key = (cfg.seed + 1, 0) if stochastic else None
    E, G = objective.energy_and_grad(X, key)
    e_host, g_host = _host_scalars(E, torch.linalg.norm(G))
    energies = [e_host]
    gnorms = [g_host]
    steps: list[float] = []
    times = [0.0]
    fevals = [1]
    ema = e_host

    converged = False
    diags: list[dict] = []
    t_loop = time.perf_counter()
    it = 0
    for it in range(1, cfg.max_iters + 1):
        if fused_step is not None:
            X, E, G, state, alpha, n_ev = fused_step(X, E, G, state, alpha)
            e_rec, g_host, alpha_host = _host_scalars(
                E, torch.linalg.norm(G), alpha)
        else:
            n_ev = 0
            if stochastic:
                # one draw a iteration: the line search descends a fixed
                # surrogate (common random numbers)
                key = (cfg.seed + 1, it)
                E, G = objective.energy_and_grad(X, key)
                e_host, g_host = _host_scalars(E, torch.linalg.norm(G))
                n_ev += 1
            else:
                e_host = energies[-1]
            P, state = solve(state, X, G)
            alpha0 = initial_step(X, P, alpha_host, cfg.ls)
            alpha_host, e_new, n_bt = host_backtrack(
                lambda Xn: float(objective.energy(Xn, key)),
                X, e_host, G, P, alpha0, cfg.ls)
            n_ev += n_bt
            X = X + alpha_host * P
            if stochastic:
                e_rec = e_new   # this iteration's surrogate, accepted X
            else:
                E, G = objective.energy_and_grad(X, key)
                e_rec, g_host = _host_scalars(E, torch.linalg.norm(G))
                n_ev += 1
        now = time.perf_counter() - t_loop
        energies.append(e_rec)
        gnorms.append(g_host)
        steps.append(alpha_host)
        times.append(now)
        fevals.append(fevals[-1] + n_ev)
        if callback is not None:
            extras = obj_diag() if obj_diag is not None else {}
            diag = {"it": it, "energy": e_rec, "grad_norm": gnorms[-1],
                    "alpha": alpha_host, "n_evals": n_ev, "t": now,
                    "iter_s": now - times[-2], **extras}
            diags.append(diag)
            callback(it, X, e_rec, diag)
        if conv == "ema":
            ema_new = cfg.ema_decay * ema + (1.0 - cfg.ema_decay) * e_rec
            rel = abs(ema - ema_new) / max(abs(ema_new), 1e-30)
            ema = ema_new
        else:
            rel = abs(energies[-2] - e_rec) / max(abs(e_rec), 1e-30)
        if rel < cfg.tol:
            converged = True
            break
        if (cfg.max_seconds is not None
                and agree_elapsed(now) > cfg.max_seconds):
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
                      seed=spec.seed, max_seconds=spec.max_seconds)
