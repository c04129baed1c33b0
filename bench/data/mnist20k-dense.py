"""MNIST-shaped clustered data for `mnist20k-dense`, made on the device.

The pattern of `data/synthetic.mnist_like` (the repository's MNIST
stand-in): `n_classes` clusters, each an anisotropic Gaussian on an
8-dimensional linear manifold in R^784, with isotropic noise.  The points
are one fixed set, drawn from the configuration's `structure_seed` and
`points_seed`; `--seed` permutes their order.  So every seed fits the same
problem in another order and does the same work, and the seed still
changes the inputs (and the order of every sum over points).
"""
from __future__ import annotations

import torch


def make(config: dict, seed: int, device) -> torch.Tensor:
    """The (n, dim) float32 data of this run, on `device`."""
    d = config["data"]
    n, dim, c, m = config["n"], config["dim"], d["n_classes"], d["manifold_dim"]
    dev = torch.device(device)
    gs = torch.Generator(device=dev).manual_seed(d["structure_seed"])
    centers = torch.randn((c, dim), generator=gs, device=dev) * d["center_scale"]
    bases = torch.randn((c, m, dim), generator=gs, device=dev)
    gp = torch.Generator(device=dev).manual_seed(d["points_seed"])
    labels = torch.randint(0, c, (n,), generator=gp, device=dev)
    z = torch.randn((n, m), generator=gp, device=dev)
    noise = torch.randn((n, dim), generator=gp, device=dev)
    Y = centers[labels] + d["noise"] * noise
    for k in range(c):                       # one class at a time: no (n, m, dim)
        rows = torch.nonzero(labels == k).squeeze(1)
        Y[rows] += d["manifold_scale"] * (z[rows] @ bases[k])
    order = torch.randperm(n, generator=torch.Generator(device=dev)
                           .manual_seed(seed), device=dev)
    return Y[order].contiguous()
