"""Synthetic embedding datasets (numpy).

Copies of `coil_like`, `mnist_like` and `swiss_roll` from
`repro/data/synthetic.py`: the same draws from the same seeds, so both
packages fit identical data.
"""
from __future__ import annotations

import numpy as np


def coil_like(n_per: int = 72, loops: int = 10, dim: int = 256,
              seed: int = 0, noise: float = 0.02,
              separation: float = 1.2) -> np.ndarray:
    """Rotation-sequence-like data: `loops` closed 1-D manifolds in R^dim
    (the structure of COIL-20 image sequences).  `separation` keeps the
    perplexity-20 affinity graph connected with weak cross-object links,
    as with real COIL-20 images."""
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 2 * np.pi, n_per, endpoint=False)
    pts = []
    for _ in range(loops):
        center = rng.normal(size=dim) * separation
        basis = rng.normal(size=(2, dim))
        circ = np.stack([np.cos(ts), np.sin(ts)], -1) @ basis
        pts.append(circ + center + noise * rng.normal(size=(n_per, dim)))
    return np.concatenate(pts).astype(np.float32)


def mnist_like(n: int = 2000, dim: int = 784, n_classes: int = 10,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Clustered data with MNIST-ish geometry: `n_classes` anisotropic
    Gaussian clusters on low-dimensional manifolds in R^dim."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    centers = rng.normal(size=(n_classes, dim)) * 3.0
    sub = rng.normal(size=(n_classes, 8, dim))  # 8-dim class manifolds
    z = rng.normal(size=(n, 8))
    Y = centers[labels] + np.einsum("nk,nkd->nd", z, sub[labels]) * 0.5
    Y += 0.1 * rng.normal(size=(n, dim))
    return Y.astype(np.float32), labels


def swiss_roll(n: int = 1000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = 1.5 * np.pi * (1 + 2 * rng.uniform(size=n))
    h = 21 * rng.uniform(size=n)
    Y = np.stack([t * np.cos(t), h, t * np.sin(t)], axis=1)
    return (Y + 0.05 * rng.normal(size=Y.shape)).astype(np.float32)
