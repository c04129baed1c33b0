"""RPR001 fixture: host syncs inside hot scopes (`fit_loop`, `pcg`)."""
import numpy as np
import torch

from repro_torch.analysis.guards import explicit_read


def fit_loop(objective, X, n):
    for _ in range(n):
        E, G = objective.energy_and_grad(X)
        e = float(E)                       # RPR001: tainted via unpack
        g = float(torch.linalg.norm(G))    # RPR001: direct tensor read
        s = E.item()                       # RPR001: .item() sync
        X = X - 0.1 * G
        snap = np.asarray(G)               # RPR001: implicit transfer
        host = G.cpu()                     # RPR001: .cpu() copy
        torch.cuda.synchronize()           # RPR001: waits for the card
    return X, e, g, s, snap, host


def fit_loop_clean(objective, X, n):
    for _ in range(n):
        E, G = objective.energy_and_grad(X)
        # the sanctioned form: one batched read of the step's scalars
        e, g = _host_scalars(E, torch.linalg.norm(G))
        X = X - 0.1 * G
    return X, float(e), g


def pcg(r, tol, maxiter):
    k = 0
    while k < maxiter and bool(torch.linalg.norm(r) > tol):   # RPR001
        k += 1
    flag = torch.linalg.norm(r) > tol
    with explicit_read():                  # the sanctioned flag read
        done = bool(flag)
    return k, done


def _host_scalars(*values):
    return torch.stack(values).cpu().tolist()


def cold_path(cfg):
    # not a hot scope: conversions here are fine
    return float(torch.as_tensor(cfg.scale))
