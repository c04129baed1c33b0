"""Kernel 1's share of its roofline in the traced fit: its launches'
counted work (`counts/pairwise.py`) at the published H100 peaks, over the
device time of its two kernels (`pairwise_rows`, `reduce_partials`)."""
from counts import pairwise, peaks


def read(ctx):
    trace = ctx["trace"]
    seconds, _ = trace.kernel_time("pairwise_rows", "reduce_partials")
    _, launches = trace.kernel_time("pairwise_rows")
    if not launches or seconds <= 0:
        return None
    flops, nbytes = pairwise.work(ctx["n"], ctx["d"])
    return 100.0 * launches * peaks.bound_s(flops, nbytes) / seconds
