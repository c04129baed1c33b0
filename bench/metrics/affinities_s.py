"""Seconds of the set-up fit's affinities: the dense backend's N x N
calibration (`affinities_s`), or the sparse graph's kNN search,
calibration and reverse graph (`knn_s + calibrate_s + reverse_s`), from
`EngineResult.phase_times`, whose blocks synchronise before they close."""


def read(ctx):
    t = ctx["phase_times"]
    if "affinities_s" in t:
        return t["affinities_s"]
    parts = [t[k] for k in ("knn_s", "calibrate_s", "reverse_s") if k in t]
    return sum(parts) if parts else None
