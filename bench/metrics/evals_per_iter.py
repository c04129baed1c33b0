"""Energy evaluations an iteration of a window fit, the first evaluation
included (`EngineResult.n_fevals` over `n_iters`): the line search's
trials and the gradients."""


def read(ctx):
    fit = ctx["fit"]
    return fit["n_fevals"][-1] / fit["n_iters"] if fit["n_iters"] else None
