"""The whole iteration's share of the chip's peak: the iteration's counted
work (`counts/iteration.py`: evaluations, direction, each fit's direction
set-up) at the published H100 peaks, the larger of the operations and
bytes bounds, over the window's measured seconds an iteration (the
untraced fits of the traced run)."""
from counts import iteration, peaks


def read(ctx):
    w = iteration.work(ctx)
    if w is None:
        return None
    return 100.0 * peaks.bound_s(*w) / ctx["window_iter_s"]
