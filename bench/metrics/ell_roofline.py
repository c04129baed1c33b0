"""The ELL kernels' share of their roofline in the traced fit: each
forward and reverse product's bytes over the live slots
(`counts/ell.py`) at the published H100 bandwidth, over the device time of
the `ell_gather` kernels.  Products come in pairs, one on each graph."""
from counts import ell, peaks


def read(ctx):
    seconds, launches = ctx["trace"].kernel_time("ell_gather")
    g = ctx["graph"]
    if not launches or seconds <= 0 or "live_reverse" not in g:
        return None
    n, d = ctx["n"], ctx["d"]
    f1, b1 = ell.product(n, d, g["live_forward"])
    f2, b2 = ell.product(n, d, g["live_reverse"])
    pair = peaks.bound_s(f1, b1) + peaks.bound_s(f2, b2)
    return 100.0 * (launches / 2) * pair / seconds
