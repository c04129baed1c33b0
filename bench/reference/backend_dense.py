"""The reference of the dense backend and the numbers that judge a run.

From the data Y alone it computes W+ (`affinities_dense`), and from the
program's spectral start X0, checked on its own first (`spectral_dense`),
it follows the judged window fit's `iters` steps in float64 with its own
objective (`objective_dense`), the traffic's direction
(`direction_<strategy>_dense`: SD's exact solve) and line search
(`linesearch`).  Starting from the program's X0 is the one
place where the reference takes a state of the program's; the start is
held to its own two numbers instead.

The numbers (each against the cell's limit), all of one fit of the window
drawn from the seed, as the window's own call produced it:

  * `loss_gap`: the worst relative gap of E_0 .. E_k over the first k =
    `warm_iters` steps, which the reference follows on its own;
  * `grad0_gap`: of the first gradient's norm;
  * `move_gap`: of ||X_k - X_0||, the parameters' change after k steps;
  * `energy_gap`, `dir_resid`, `step_gap`: every step of the whole fit,
    each from the program's iterate before it (`steps.py`);
  * `final_energy_gap`: of the energy the fit reports at the embedding it
    returns against the reference's energy at that embedding;
  * `start_resid`, `start_rank`: the spectral start's (`spectral_dense`).
"""
from __future__ import annotations

import torch

from reference import affinities_dense, linesearch, objective_dense
from reference import direction_module, spectral_dense, steps
from reference.gaps import max_rel_gap, rel_gap


def follow(W, X0, spec, direction, n_steps):
    """The first `n_steps` steps of the dense fit from X0 in float64: the
    energies, the first gradient's norm and X at the end."""
    kind, lam = spec["kind"], float(spec["lam"])
    X = X0.double()
    E, G = objective_dense.energy_and_grad(X, W, kind, lam)
    energies, g0 = [E], float(torch.linalg.norm(G))
    alpha = 1.0
    for _ in range(n_steps):
        P = direction(X, G)
        a0 = linesearch.initial_step(X, P, alpha, direction.INITIAL_STEP)
        alpha, _, _ = linesearch.dense_step(
            lambda Xn: objective_dense.energy(Xn, W, kind, lam),
            X, E, G, P, a0)
        X = X + alpha * P
        E, G = objective_dense.energy_and_grad(X, W, kind, lam)
        energies.append(E)
    return energies, g0, X


def judge(run) -> dict[str, float]:
    """`run` holds the benchmark's inputs (`Y`, `config`, `traffic`) and
    the program's outputs to judge (`X0`, `fit`)."""
    spec = {**run["config"]["spec"], **run["traffic"]["spec"]}
    kind, lam = spec["kind"], float(spec["lam"])
    keep = int(run["traffic"]["warm_iters"])
    W = affinities_dense.attractive(run["Y"], float(spec["perplexity"]), kind)
    out = spectral_dense.check(W, run["X0"])
    fit = run["fit"]
    X0 = run["X0"].double()
    direction = direction_module(spec["strategy"], "dense").Direction(W, spec)
    energies, g0, X_keep = follow(W, X0, spec, direction, keep)
    out["loss_gap"] = max_rel_gap(fit["energies"][:keep + 1], energies)
    out["grad0_gap"] = rel_gap(fit["grad_norms"][0], g0)
    out["move_gap"] = rel_gap(
        torch.linalg.norm(fit["states"][keep - 1].double() - X0),
        torch.linalg.norm(X_keep - X0))
    out.update(steps.check(
        X0, fit["states"], fit,
        lambda X, k: objective_dense.energy(X, W, kind, lam),
        lambda X, k: objective_dense.energy_and_grad(X, W, kind, lam),
        direction.matvec, linesearch.dense_step, direction.INITIAL_STEP))
    out["final_energy_gap"] = rel_gap(
        fit["energies"][-1], objective_dense.energy(fit["X"], W, kind, lam))
    return out
