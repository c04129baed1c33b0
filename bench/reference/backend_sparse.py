"""The reference of the sparse backend and the numbers that judge a run.

From the data Y alone it builds its own graph (`knn_approx`,
`calibrate_ell`) and spectral start (`spectral_sparse`), remaking the
program's draws from the same seed; from the program's spectral start,
held to its own number first, it follows the judged window fit's first
steps in float64 (`objective_sparse` with the same negatives, the
traffic's direction `direction_<strategy>_sparse`, the sparse line search
of `linesearch`), and then judges every step of the fit from the
program's iterate before it (`steps.py`).  Starting from the program's X0
is the one place where its own trajectory takes a state of the program's:
it keeps the trajectory's check apart from the start's.

The numbers (each against the cell's limit), all of one fit of the window
drawn from the seed:

  * `graph_rows`, `graph_farther`, `graph_weights` (`graph_readings`):
    the program's graph beside the reference's.  The approximate search
    orders 1.3M projected values, and float32 reorders near ties, so the
    two searches see other candidates on many rows: these are readings,
    not held to a limit; the weights are checked through the energies;
  * `energy_gap`, `dir_resid`, `step_gap`, `final_energy_gap`: every step
    of the whole fit from the program's iterate before it (`steps.py`), on
    the program's neighbour lists with the reference's own weights (the
    lists are a discrete choice, read above: the second place where the
    reference follows a state of the program's), with the same draws;
  * `start_gap`: the program's start against the reference's, after the
    best rotation and reflection;
  * `loss_gap`, `grad0_gap`, `move_gap`: the first `warm_iters` steps,
    which the reference follows on its own graph, as on the dense backend
    (`backend_dense.py`)."""
from __future__ import annotations

import torch

from reference import (calibrate_ell, direction_module, graph_ops,
                       knn_approx, linesearch, objective_sparse,
                       spectral_sparse, steps)
from reference.gaps import max_rel_gap, procrustes_gap, rel_gap


def neighbour_d2(Y: torch.Tensor, idx: torch.Tensor, block: int = 65536
                 ) -> torch.Tensor:
    """Squared distances (float64) from each point to its listed
    neighbours."""
    Y = Y.double()
    out = torch.empty(idx.shape, dtype=torch.float64, device=Y.device)
    for r0 in range(0, idx.shape[0], block):
        out[r0:r0 + block] = torch.sum(
            (Y[r0:r0 + block, None, :] - Y[idx[r0:r0 + block]]) ** 2, -1)
    return out


def graph_readings(Y, prog_idx, prog_w, idx, w, d2, perplexity, kind):
    """The program's graph beside the reference's: the share of rows whose
    live neighbour sets differ, how much farther (or nearer) its
    neighbours lie in all, and its weights against the reference's
    calibration of the same neighbour lists.  Returns the readings and
    the reference's weights on the program's lists."""
    n = prog_idx.shape[0]
    big = n + 1
    ps = torch.sort(torch.where(prog_w != 0, prog_idx, big), 1).values
    rs = torch.sort(torch.where(w != 0, idx, big), 1).values
    pd2 = neighbour_d2(Y, prog_idx)
    far = (float(torch.where(prog_w != 0, pd2, 0.0).sum())
           / float(torch.where(w != 0, d2, 0.0).sum()) - 1.0)
    own = prog_idx == torch.arange(n, device=Y.device)[:, None]
    _, w_prog_lists = calibrate_ell.weights(
        torch.where(own, torch.inf, pd2), prog_idx, perplexity, kind)
    wgap = float((w_prog_lists - prog_w).abs().max()
                 / w_prog_lists.abs().max())
    return ({"graph_rows": float((~torch.all(ps == rs, 1)).sum()) / n,
             "graph_farther": far, "graph_weights": wgap}, w_prog_lists)


def judge(run) -> dict[str, float]:
    config, traffic = run["config"], run["traffic"]
    spec = {**config["spec"], **traffic["spec"]}
    kind, lam = spec["kind"], float(spec["lam"])
    seed = int(spec.get("seed", 0))
    Y = run["Y"]
    k = int(spec["n_neighbors"])
    perplexity = float(spec["perplexity"])
    d2, idx = knn_approx.knn(Y, k, seed)
    idx, w = calibrate_ell.weights(d2, idx, perplexity, kind)
    prog_idx = run["graph"].indices.long()
    out, w_lists = graph_readings(Y, prog_idx,
                                  run["graph"].weights.double(), idx, w, d2,
                                  perplexity, kind)
    del d2
    keep = int(traffic["warm_iters"])
    fit = run["fit"]
    m, decay = int(spec["n_negatives"]), float(spec.get("z_ema_decay", 0.9))
    piece = direction_module(spec["strategy"], "sparse")
    obj = objective_sparse.Objective(prog_idx, w_lists, kind, lam, m,
                                     seed + 1, decay)
    out.update(steps.check(
        run["X0"], fit["states"], fit,
        lambda X, k: obj(X, k, with_grad=False)[0], obj,
        piece.Direction(graph_ops.SymGraph(prog_idx, w_lists), spec).matvec,
        linesearch.sampled_step, piece.Direction.INITIAL_STEP))
    out["final_energy_gap"] = rel_gap(
        fit["energies"][-1],
        obj(fit["X"], fit["n_iters"], with_grad=False)[0])
    del w_lists, prog_idx, obj
    W = graph_ops.SymGraph(idx, w)
    out["start_gap"] = procrustes_gap(
        run["X0"], spectral_sparse.start(W, int(spec["dim"]), seed))

    obj = objective_sparse.Objective(idx, w, kind, lam, m, seed + 1, decay)
    direction = piece.Direction(W, spec)
    X0 = run["X0"].double()
    X = X0
    E, G = obj(X, 0)
    energies, g0 = [E], float(torch.linalg.norm(G))
    alpha = 1.0
    for it in range(1, keep + 1):
        E, G = obj(X, it)
        P = direction(X, G)
        a0 = linesearch.initial_step(X, P, alpha, piece.Direction.INITIAL_STEP)
        alpha, e_new, _ = linesearch.sampled_step(
            lambda Xn, it=it: obj(Xn, it, with_grad=False)[0],
            X, E, G, P, a0)
        X = X + alpha * P
        energies.append(e_new)
    out["loss_gap"] = max_rel_gap(fit["energies"][:keep + 1], energies)
    out["grad0_gap"] = rel_gap(fit["grad_norms"][0], g0)
    out["move_gap"] = rel_gap(
        torch.linalg.norm(fit["states"][keep - 1].double() - X0),
        torch.linalg.norm(X - X0))
    return out
