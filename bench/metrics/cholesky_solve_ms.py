"""Device milliseconds an iteration of the kernels under
`aten::cholesky_solve` (the dense SD direction's triangular solves) in
the traced fit."""


def read(ctx):
    hit = ctx["trace"].op_device_s.get("aten::cholesky_solve")
    if hit is None or not ctx["fit"]["n_iters"]:
        return None
    return 1e3 * hit[0] / ctx["fit"]["n_iters"]
