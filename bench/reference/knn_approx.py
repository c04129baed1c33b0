"""The approximate k-nearest-neighbour graph in float64: a frozen copy of
the random-projection window search.

T projection directions are drawn on the CPU from `seed` (float32 normal
draws, in this order), each point's candidates are the `window` points on
either side of it in the order of the data projected on each direction
(clamped at the ends), the union's exact distances are taken, repeated
candidates and the point itself are ruled out, and the k nearest
candidates are kept.  Returns (d2, indices) (N, k), nearest first."""
from __future__ import annotations

import torch


def projections(n_projections: int, dim: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n_projections, dim), generator=g)


def knn(Y: torch.Tensor, k: int, seed: int, n_projections: int = 8,
        window: int = 16, block: int = 8192):
    Y = Y.double()
    n = Y.shape[0]
    dev = Y.device
    U = projections(n_projections, Y.shape[1], seed).double().to(dev)
    offs = torch.cat([torch.arange(-window, 0), torch.arange(1, window + 1)]
                     ).to(dev)
    ar = torch.arange(n, device=dev)
    cands = []
    for u in U:
        order = torch.argsort(Y @ u, stable=True)
        rank = torch.empty_like(order)
        rank[order] = ar
        cands.append(order[torch.clamp(rank[:, None] + offs, 0, n - 1)])
    cand = torch.cat(cands, 1)
    del cands
    r = torch.sum(Y * Y, 1)
    d2s, idxs = [], []
    for r0 in range(0, n, block):
        cb = cand[r0:r0 + block]
        rows = ar[r0:r0 + cb.shape[0]]
        d2 = torch.clamp_min(r[rows, None] + r[cb] - 2.0 * torch.einsum(
            "bd,bcd->bc", Y[rows], Y[cb]), 0.0)
        d2 = torch.where(cb == rows[:, None], torch.inf, d2)
        cb_s, order = torch.sort(cb, dim=1, stable=True)
        d2 = torch.gather(d2, 1, order)
        dup = torch.zeros_like(cb_s, dtype=torch.bool)
        dup[:, 1:] = cb_s[:, 1:] == cb_s[:, :-1]
        d2 = torch.where(dup, torch.inf, d2)
        vals, slot = torch.topk(d2, k, 1, largest=False)
        d2s.append(vals)
        idxs.append(torch.gather(cb_s, 1, slot))
    return torch.cat(d2s), torch.cat(idxs)
