"""The whole iteration's work, averaged over a fit of the cell, from the
traced fit's counts: every energy evaluation, the direction, and each
fit's direction set-up spread over its iterations (`iter_ms` includes
it).  Returns None where a count it needs is missing."""
from __future__ import annotations

from counts import ell, pairwise, triangular


def work(ctx: dict) -> tuple[float, float] | None:
    fit, traffic, config = ctx["fit"], ctx["traffic"], ctx["config"]
    spec = {**config["spec"], **traffic["spec"]}
    n, d, iters = ctx["n"], ctx["d"], fit["n_iters"]
    evals = fit["n_fevals"][-1]
    backend, strategy = spec["backend"], spec["strategy"]
    flops = nbytes = 0.0
    if backend == "dense":
        f, b = pairwise.work(n, d)
        flops, nbytes = evals * f, evals * b
        if strategy == "sd":
            refine = int(spec.get("strategy_opts", {}).get("refine", 1))
            f, b = triangular.direction(n, d, refine)
            f0, b0 = triangular.factor(n)
            flops += iters * f + f0
            nbytes += iters * b + b0
        else:
            return None
    elif backend == "sparse":
        g = ctx["graph"]
        if "live_reverse" not in g:
            return None
        lf, lr = g["live_forward"], g["live_reverse"]
        m = int(spec["n_negatives"])
        grads = iters + 1                    # the first, then one a step
        for with_grad, k in ((True, grads), (False, evals - grads)):
            f, b = ell.evaluation(n, d, lf, lr, m, with_grad)
            flops, nbytes = flops + k * f, nbytes + k * b
        if strategy == "sd":
            diags = fit.get("diagnostics") or []
            if not diags or "pcg_iters" not in diags[0]:
                return None
            cg = sum(x["pcg_iters"] for x in diags)
            f, b = ell.pcg_iteration(n, d, lf, lr)
            flops, nbytes = flops + cg * f, nbytes + cg * b
        else:
            return None
    else:
        return None
    return flops / iters, nbytes / iters
