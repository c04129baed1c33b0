"""The share of the traced fit's wall time in which no kernel ran on the
device (the union of the kernels' intervals from the profiler)."""


def read(ctx):
    t = ctx["trace"]
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)
