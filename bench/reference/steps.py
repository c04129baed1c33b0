"""The check of a whole fit, step by step from the program's own iterates.

A float64 reference that follows a fit of many steps on its own parts from
the program's float32 trajectory within a few steps: the early steps of a
fit amplify rounding tenfold a step, so after ten of them the two are
different (equally sound) trajectories.  Past the first steps, which the
backends follow on their own, the reference therefore starts every step
anew from the program's iterate X_k-1, the one state of the program's it
takes here, and judges what the program did with it:

  * `energy_gap`: the worst relative gap between the energy the fit
    reports at each iterate X_k (k = 0 .. iters) and the reference's energy
    there (of the same draw, on the sparse backend);
  * `dir_resid`: the worst ||B P_k + G_k-1|| / ||G_k-1|| of the program's
    direction P_k = (X_k - X_k-1) / alpha_k against the reference's system
    B and gradient G_k-1 at X_k-1: a direction that was not solved again,
    or solved against another gradient, reads of order 1;
  * `step_gap`: the worst relative gap between the program's step size
    alpha_k and the one the reference's line search takes along P_k from
    X_k-1 (from the program's previous step, by the same policy): 0 where
    they agree.  Where the two differ by one backtracking decision (a
    factor rho), the Armijo test at the larger step is read instead: its
    slack over |E_k-1| is of the energies' rounding where float32 and
    float64 merely fall on two sides of the test, and large where the
    program's search decided otherwise.
"""
from __future__ import annotations

import torch

from reference import linesearch
from reference.gaps import rel_gap, worst


def check(X0, states, fit, energy_at, grad_at, matvec, search,
          policy: str) -> dict[str, float]:
    """`states[k - 1]` is the program's X_k; `energy_at(X, k)` the
    reference's energy of step k's draw at X, `grad_at(X, k)` its (E, G)
    for step k's direction, `matvec(V)` the reference's B V, and
    `search(energy, X, e0, G, P, alpha0)` its line search."""
    Xs = [X0.double()] + [x.double() for x in states]
    alphas, energies = fit["step_sizes"], fit["energies"]
    # E_0 is a gradient evaluation in the program (it advances a sampled
    # objective's streaming state), so it is one here too
    out = {"energy_gap": rel_gap(energies[0], grad_at(Xs[0], 0)[0]),
           "dir_resid": 0.0, "step_gap": 0.0}
    for k in range(1, len(Xs)):
        X = Xs[k - 1]
        e0, G = grad_at(X, k)
        P = (Xs[k] - X) / alphas[k - 1]
        out["dir_resid"] = worst(out["dir_resid"], float(
            torch.linalg.norm(matvec(P) + G) / torch.linalg.norm(G)))
        a0 = linesearch.initial_step(X, P, alphas[k - 2] if k > 1 else 1.0,
                                     policy)
        a, _, _ = search(lambda Xn, k=k: energy_at(Xn, k), X, e0, G, P, a0)
        gap = rel_gap(alphas[k - 1], a)
        if min(abs(gap - 1.0), abs(gap - 1.0 + linesearch.RHO)) < 1e-4:
            big = max(alphas[k - 1], a)
            gap = abs(energy_at(X + big * P, k) - e0 - linesearch.C1 * big
                      * float(torch.sum(G * P))) / abs(e0)
        out["step_gap"] = worst(out["step_gap"], gap)
        out["energy_gap"] = worst(out["energy_gap"],
                                  rel_gap(energies[k], energy_at(Xs[k], k)))
    return out
