"""Single-cell-shaped data for `tenx1m3-sparse`, made on the device.

The shape of the 10x Genomics 1.3M mouse brain cells after PCA: N cells
by the first 50 principal components.  The matrix itself is not in the
repository, so its structure is assumed (the configuration's `assumed`):
`n_clusters` cell types with Zipf-distributed sizes, component scales that
decay as j^-decay over the 50 components (as a PCA spectrum does), cluster
centres spread `center_scale` times those scales, and per-cluster,
per-component spreads in [0.5, 1.5) of them.  The points are one fixed set,
drawn from `structure_seed` and `points_seed`; `--seed` rotates their order
cyclically by an offset drawn from it, and reverses it on half the seeds.
Such an order keeps every pair's index distance up to its sign, and the
program samples its negatives as cyclic shifts of the index (row n's are
n + s_j mod N, applied symmetrically), so every seed samples the same pairs
of points: every seed fits the same problem with the same draws and does
the same work, in another order.
"""
from __future__ import annotations

import random

import torch


def make(config: dict, seed: int, device) -> torch.Tensor:
    """The (n, dim) float32 data of this run, on `device`."""
    d = config["data"]
    n, dim, c = config["n"], config["dim"], d["n_clusters"]
    dev = torch.device(device)
    gs = torch.Generator(device=dev).manual_seed(d["structure_seed"])
    scale = torch.arange(1, dim + 1, device=dev,
                         dtype=torch.float32) ** -d["decay"]
    sizes = torch.arange(1, c + 1, device=dev, dtype=torch.float32) ** -1.0
    centers = (torch.randn((c, dim), generator=gs, device=dev) * scale
               * d["center_scale"])
    spread = 0.5 + torch.rand((c, dim), generator=gs, device=dev)
    gp = torch.Generator(device=dev).manual_seed(d["points_seed"])
    labels = torch.multinomial(sizes / sizes.sum(), n, replacement=True,
                               generator=gp)
    Y = torch.randn((n, dim), generator=gp, device=dev)
    Y.mul_(scale * spread[labels]).add_(centers[labels])
    draw = random.Random(seed)
    offset, sign = draw.randrange(n), draw.choice((1, -1))
    order = (offset + sign * torch.arange(n, device=dev)) % n
    return Y[order].contiguous()
