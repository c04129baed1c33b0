"""RPR003 fixture: tensor factories without device= in a hot scope."""
import torch


def fit_loop(X, n):
    for it in range(n):
        step = torch.tensor(0.5)                   # RPR003: CPU tensor
        rows = torch.arange(X.shape[0])            # RPR003: CPU tensor
        X = X - step.to(X.device) * X[rows.to(X.device)]
    return X


def fit_loop_clean(X, n):
    for it in range(n):
        step = torch.full((), 0.5, device=X.device)
        rows = torch.arange(X.shape[0], device=X.device)
        X = X - step * X[rows]
    return X


def build(n):
    # not a hot scope: built once
    return torch.zeros(n)
