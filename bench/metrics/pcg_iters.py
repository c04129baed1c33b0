"""Mean PCG iterations a step of the traced fit, from the fit's
diagnostics (`pcg_iters`, the sparse backend's solver counter)."""


def read(ctx):
    diags = ctx["fit"].get("diagnostics") or []
    its = [d["pcg_iters"] for d in diags if "pcg_iters" in d]
    return sum(its) / len(its) if its else None
