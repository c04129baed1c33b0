"""One run of one cell: set-up, the measured window, the traced fit, the
check against the reference, and the result.

Set-up (timed from the process's start as `setup_s`): the program is
imported and its kernels loaded, the cell's data is made on the device
from the seed, and one short fit through `Embedding.fit(Y)` builds the
affinities and the spectral start (every kernel built, every launch shape
searched).  A second short fit through the window's own call warms that
call.

The window: whole fits of the traffic's `iters` iterations with tol = 0,
one after another from the same start through `Embedding.fit(None, X0=,
aff= | saff=)` (each pays its own direction-solver set-up), until
`seconds` have passed; `iter_ms` is the window's seconds over every
iteration it completed.  Every fit keeps its iterates for the check (a
callback that copies X, 10 MB an iterate at the sparse cell's N).  Nothing may be built or
searched in the window (`analysis.guards.CompileCounter`).  With `trace`,
one more fit runs first under `torch.profiler` and the per-layer metrics
are read from it.

After the window `memory_peak_bytes` is read, the program's state is
dropped, and the reference judges one window fit drawn from the seed: its
first steps and every step of it (`reference/backend_<backend>.py`)."""
from __future__ import annotations

import math
import random
import time

from . import trace as tracing
from .env import check_devices, import_program
from .manifest import Cell, metric_reader


def _summary(res) -> dict:
    return {"energies": [float(e) for e in res.energies],
            "grad_norms": [float(g) for g in res.grad_norms],
            "step_sizes": [float(a) for a in res.step_sizes],
            "n_fevals": [int(f) for f in res.n_fevals],
            "n_iters": int(res.n_iters), "X": res.X,
            "diagnostics": res.diagnostics}


def _finite(s: dict) -> bool:
    import torch
    return (all(math.isfinite(e) for e in s["energies"])
            and bool(torch.isfinite(s["X"]).all()))


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", control: bool = False,
        config_overrides: dict | None = None,
        require_device: bool = True) -> dict:
    """The result of one run (the dict printed as the last line).

    `control` switches on the program's own lower-precision path
    (`kernel_precision="bfloat16"`), the control of the correctness check;
    `config_overrides` and `device="cpu"` with `require_device=False` let
    the CPU tests drive the whole run at a tiny size."""
    if require_device:
        check_devices(cell.chips)
    import_program()
    import torch
    from repro_torch.analysis.guards import CompileCounter
    from repro_torch.api import Embedding, EmbedSpec

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    config = {**cell.config, **(config_overrides or {})}
    traffic = cell.traffic
    phases = {"import_s": time.perf_counter() - t_start}
    Y = cell.data_generator().make(config, seed, dev)
    spec = EmbedSpec(**{**config["spec"], **traffic["spec"],
                        "max_iters": int(traffic["iters"]), "tol": 0.0})
    if control:
        spec = spec.replace(kernel_precision="bfloat16")
    warm_spec = spec.replace(max_iters=int(traffic["warm_iters"]))

    t = time.perf_counter()
    warm = Embedding(warm_spec, device=dev).fit(Y)
    aff, X0 = warm.affinities_, warm.X0_
    inputs = {"saff": aff} if hasattr(aff, "graph") else {"aff": aff}
    phase_times = dict(warm.result_.phase_times)
    del warm

    def fit(s=spec):
        states = []            # the fit's iterates X_1 .., for the check

        def callback(it, X, e, diag):
            states.append(X.clone())
        est = Embedding(s, device=dev).fit(None, X0=X0, callback=callback,
                                           **inputs)
        out = _summary(est.result_)
        out["states"] = states
        return out

    fit(warm_spec)
    if cuda:
        torch.cuda.synchronize(dev)
    phases["warm_fits_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    summary = None
    # the fit to judge, drawn from the seed uniformly over the window's fits
    # as they come (reservoir sampling): one fit's tensors are kept at a time
    draw = random.Random(seed)
    judged, n_fits, iters, failed, evals, cg = None, 0, 0, 0, 0, 0
    with CompileCounter() as builds:
        if trace:
            t = time.perf_counter()
            traced, summary = tracing.traced(
                fit, device_type=None if cuda else _cpu_device_type())
            phases["trace_s"] = time.perf_counter() - t
        t0 = time.perf_counter()
        while True:
            f = fit()
            n_fits += 1
            iters += f["n_iters"]
            failed += not _finite(f)
            evals += f["n_fevals"][-1]
            cg += sum(x.get("pcg_iters", 0) for x in f["diagnostics"] or [])
            if draw.randrange(n_fits) == 0:
                judged = f
            del f
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    phases["window_s"] = window_s
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    metrics = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        ctx = {"trace": summary, "fit": traced, "phase_times": phase_times,
               "window_iter_s": window_s / iters, "config": config,
               "traffic": traffic, "graph": _graph_sizes(aff),
               "n": int(X0.shape[0]), "d": int(X0.shape[1])}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": summary.device_ops(),
                     "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    else:
        ms = 1e3 * window_s / iters          # both names: one reading
        values = {"iter_ms": ms, "sparse_iter_ms": ms,
                  "peak_gib": peak / 2**30, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # the check: the window fit drawn from the seed
    graph = getattr(aff, "graph", None)
    del inputs, aff
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = cell.reference().judge({
        "Y": Y, "config": config, "traffic": traffic, "X0": X0,
        "fit": judged, "seed": seed, "graph": graph})
    phases["reference_s"] = time.perf_counter() - t
    # the window's work, beside its time: what a seed asks of the program
    numbers["window_evals_per_iter"] = evals / iters
    if cg:
        numbers["window_pcg_iters"] = cg / iters
    numbers["window_builds"] = float(builds.count)
    numbers["failed_fits"] = float(failed)
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    readings = {k: v for k, v in numbers.items() if k not in checks}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": n_fits, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["phases"] = phases
    out["readings"] = readings
    out["checks"] = checks
    return out


def _graph_sizes(aff) -> dict:
    """Live (nonzero-weight) slots of the ELL graphs, for the ELL counts."""
    if not hasattr(aff, "graph"):
        return {}
    out = {"live_forward": int((aff.graph.weights != 0).sum()),
           "k_forward": int(aff.graph.k)}
    if aff.rev is not None:
        out.update(live_reverse=int((aff.rev.weights != 0).sum()),
                   k_reverse=int(aff.rev.k))
    return out


def _cpu_device_type():
    from torch.autograd import DeviceType
    return DeviceType.CPU
