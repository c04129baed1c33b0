"""Seconds of the set-up fit's spectral start (`phase_times`)."""


def read(ctx):
    return ctx["phase_times"].get("spectral_init_s")
