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
    carry_state()      objective-side state to checkpoint (a pytree, e.g.
                       the normalized sparse models' streaming z), saved
                       with every checkpoint and put back on resume by
    restore_carry(t)   AFTER the engine's initial evaluation (which may
                       advance it), so that the first resumed iteration sees
                       what the uninterrupted run saw
    share_checkpoint(write)  runs `write()` (the save) on one rank and
                       returns on every rank once it is on disk, raising on
                       every rank if it failed: the sharded backend, whose
                       ranks all run this loop on the same replicated state

The draw key of iteration `it` is the pair (seed + 1, it), the counterpart
of the reference's `fold_in(PRNGKey(seed + 1), it)`; the initial evaluation
uses it = 0 (on resume, the step resumed from).  A deterministic objective
gets key None.

Checkpoint/resume (`LoopConfig.checkpoint_dir`): every `checkpoint_every`
iterations and at the end the engine saves X, the accepted step (float64),
the EMA, the direction solver's state, the current (E, G) and the
objective's carry (`ckpt.Checkpointer`, the reference's payload and
layout); a loop started on a directory that holds a checkpoint resumes
from its newest step.  A deterministic objective resumes from the saved
(E, G) without evaluating again (the fused step's (E, G) need not be what a
standalone evaluation gives, bit for bit); a stochastic one evaluates once
with the resumed step's key and then gets its carry back.  So the resumed
trajectory is the uninterrupted one, bit for bit, on the CPU and on CUDA
(whose kernels sum in a fixed order).

Telemetry (`telemetry=`, a `repro_torch.obs.Telemetry`): the spans
``setup``, ``compile`` (the first evaluation; on CUDA it includes the
kernels' first-use build and load, `kernels/_build.py`), one ``solve-iter``
an iteration and ``checkpoint``, and one `IterationRecord` an iteration
with the objective's diagnostics and the fit device's memory counters.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.analysis.guards import explicit_read
from repro_torch.ckpt import Checkpointer
from repro_torch.core.linesearch import LSConfig
from repro_torch.obs import IterationRecord, device_memory_stats, span


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
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
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
    resumed_from: int | None = None         # the checkpoint step resumed
    state: Any = None         # final direction-solver state
    diagnostics: list[dict] | None = None   # per-iteration table, when a
                                            # callback, on_iteration or
                                            # telemetry listens
    phase_times: dict = dataclasses.field(default_factory=dict)
    # seconds of the problem set-up before the loop (affinities, spectral
    # init), filled in by the backend


def _sync(X: torch.Tensor) -> None:
    """Wait for the card, once a fit, so that the set-up's seconds are
    its own: a deliberate wait (`analysis.guards.explicit_read`)."""
    if X.is_cuda:
        with explicit_read():
            torch.cuda.synchronize(X.device)


def _host_scalars(*values: torch.Tensor) -> list[float]:
    """One batched device-to-host transfer for a few 0-d tensors: the
    engine's sanctioned read (`analysis.guards.explicit_read`)."""
    with explicit_read():
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
    (gtp,) = _host_scalars(torch.dot(G.reshape(-1), P.reshape(-1)))
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
             | None = None, *,
             on_iteration: Callable[[int, torch.Tensor, dict], None]
             | None = None, telemetry=None) -> EngineResult:
    """Run the optimization loop to convergence or budget.

    Stops on relative (raw or EMA) energy decrease < tol, on max_iters, or
    on max_seconds of wall-clock (the paper's fixed-budget comparisons).
    `callback(it, X, e, diagnostics)` and `on_iteration(it, X,
    diagnostics)` see each iteration's diagnostics dict (energy, gradient
    norm, accepted step, evaluations, times, and the objective's
    `diagnostics()`).  `telemetry` is a `repro_torch.obs.Telemetry`: its
    recorder gets one record an iteration and its tracer the engine's
    spans (module docstring).  With `cfg.checkpoint_dir` the loop
    checkpoints, and resumes from the directory's newest step.
    """
    if telemetry is not None:
        with telemetry.activate():
            return _fit_loop(objective, X0, cfg, callback, on_iteration,
                             telemetry)
    return _fit_loop(objective, X0, cfg, callback, on_iteration, None)


def _fit_loop(objective, X0, cfg, callback, on_iteration,
              telemetry) -> EngineResult:
    stochastic = bool(getattr(objective, "stochastic", False))
    conv = cfg.convergence
    if conv == "auto":
        conv = "ema" if stochastic else "raw"
    if conv not in ("raw", "ema"):
        raise ValueError(f"unknown convergence mode {conv!r}")
    recorder = telemetry.recorder if telemetry is not None else None
    want_diag = (recorder is not None or callback is not None
                 or on_iteration is not None)
    record_memory = recorder is not None and recorder.record_memory
    obj_diag = getattr(objective, "diagnostics", None)
    agree_elapsed = getattr(objective, "agree_elapsed", lambda s: s)
    carry = getattr(objective, "carry_state", None)
    share = getattr(objective, "share_checkpoint", None)

    t0 = time.perf_counter()
    with span("setup", phase=True):
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
    ema = None
    ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    start_it = 0
    resumed_from = saved_eg = obj_carry = None
    if ckpt is not None and ckpt.latest_step() is not None:
        template = {"X": X, "alpha": np.zeros(()), "ema": np.zeros(()),
                    "state": state, "E": np.zeros(()), "G": X}
        if carry is not None:
            template["obj"] = carry()
        start_it, payload = ckpt.restore_latest(template)
        resumed_from = start_it
        X = payload["X"]
        alpha_host = float(payload["alpha"])
        alpha = torch.tensor(alpha_host, dtype=X0.dtype, device=X0.device)
        ema = float(payload["ema"])
        state = payload["state"]
        obj_carry = payload.get("obj")
        if not stochastic:
            saved_eg = (payload["E"], payload["G"])

    key = (cfg.seed + 1, start_it) if stochastic else None
    if saved_eg is None:
        # the first evaluation; on CUDA it builds and loads the kernels
        with span("compile", phase=True):
            E, G = objective.energy_and_grad(X, key)
            e_host, g_host = _host_scalars(E, torch.linalg.norm(G))
    else:
        # deterministic resume: the checkpointed (E, G), which is what the
        # uninterrupted run fed its next iteration
        E = torch.tensor(float(saved_eg[0]), dtype=X0.dtype,
                         device=X0.device)
        G = saved_eg[1]
        e_host, g_host = _host_scalars(E, torch.linalg.norm(G))
    if obj_carry is not None:
        objective.restore_carry(obj_carry)
    energies = [e_host]
    gnorms = [g_host]
    steps: list[float] = []
    times = [0.0]
    fevals = [1]
    if ema is None:
        ema = e_host
    if recorder is not None:
        recorder.set_meta(start_it=start_it, resumed_from=resumed_from,
                          stochastic=stochastic, max_iters=cfg.max_iters,
                          e0=e_host)

    def save(step):
        # the host floats as float64 scalars; the tensors are copied to the
        # host by the Checkpointer
        payload = {
            "X": X,
            "alpha": np.float64(alpha_host),
            "ema": np.float64(ema),
            "state": state,
            "E": np.float64(energies[-1]),
            "G": G,
        }
        if carry is not None:
            payload["obj"] = carry()
        with span("checkpoint", it=step):
            if share is None:
                ckpt.save(step, payload)
            else:
                share(lambda: ckpt.save(step, payload))

    converged = False
    diags: list[dict] = []
    t_loop = time.perf_counter()
    it = saved_at = start_it
    for it in range(start_it + 1, cfg.max_iters + 1):
        with span("solve-iter", it=it):
            if fused_step is not None:
                X, E, G, state, alpha, n_ev = fused_step(X, E, G, state,
                                                         alpha)
                e_rec, g_host, alpha_host = _host_scalars(
                    E, torch.linalg.norm(G), alpha)
            else:
                n_ev = 0
                if stochastic:
                    # one draw a iteration: the line search descends a
                    # fixed surrogate (common random numbers)
                    key = (cfg.seed + 1, it)
                    E, G = objective.energy_and_grad(X, key)
                    e_host, g_host = _host_scalars(E, torch.linalg.norm(G))
                    n_ev += 1
                else:
                    e_host = energies[-1]
                P, state = solve(state, X, G)
                alpha0 = initial_step(X, P, alpha_host, cfg.ls)
                alpha_host, e_new, n_bt = host_backtrack(
                    lambda Xn: _host_scalars(objective.energy(Xn, key))[0],
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
        diag = None
        if want_diag:
            extras = obj_diag() if obj_diag is not None else {}
            if record_memory:
                extras.update(device_memory_stats(X.device))
            diag = {"it": it, "energy": e_rec, "grad_norm": g_host,
                    "alpha": alpha_host, "n_evals": n_ev, "t": now,
                    "iter_s": now - times[-2], **extras}
            diags.append(diag)
            if recorder is not None:
                recorder.record(IterationRecord(
                    it=it, energy=e_rec, grad_norm=g_host, alpha=alpha_host,
                    n_evals=n_ev, t=now, iter_s=now - times[-2],
                    extras=extras))
        if callback is not None:
            callback(it, X, e_rec, diag)
        if on_iteration is not None:
            on_iteration(it, X, diag)
        if conv == "ema":
            ema_new = cfg.ema_decay * ema + (1.0 - cfg.ema_decay) * e_rec
            rel = abs(ema - ema_new) / max(abs(ema_new), 1e-30)
            ema = ema_new
        else:
            rel = abs(energies[-2] - e_rec) / max(abs(e_rec), 1e-30)
        if ckpt is not None and it % cfg.checkpoint_every == 0:
            save(it)
            saved_at = it
        if rel < cfg.tol:
            converged = True
            break
        if (cfg.max_seconds is not None
                and agree_elapsed(now) > cfg.max_seconds):
            break
    if ckpt is not None and saved_at != it:
        save(it)

    return EngineResult(
        X=X,
        energies=np.asarray(energies),
        grad_norms=np.asarray(gnorms),
        step_sizes=np.asarray(steps),
        times=np.asarray(times),
        n_fevals=np.asarray(fevals),
        n_iters=it - start_it,
        converged=converged,
        setup_time=setup_time,
        resumed_from=resumed_from,
        state=state,
        diagnostics=diags if want_diag else None,
    )


def make_loop_config(spec, ls: LSConfig) -> LoopConfig:
    """LoopConfig from an EmbedSpec (port of `repro/embed/trainer.py::
    make_loop_config`)."""
    return LoopConfig(max_iters=spec.max_iters, tol=spec.tol, ls=ls,
                      checkpoint_dir=spec.checkpoint_dir,
                      checkpoint_every=spec.checkpoint_every,
                      seed=spec.seed, max_seconds=spec.max_seconds)
