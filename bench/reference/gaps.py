"""The numbers that judge a program's output against the reference's."""
from __future__ import annotations

import math

import torch


def rel_gap(got: float, want: float) -> float:
    """|got - want| / |want| (a non-finite reading gives inf)."""
    got, want = float(got), float(want)
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-300)


def worst(a: float, b: float) -> float:
    """The larger reading; a NaN wins (Python's max would drop it)."""
    return b if not b <= a else a


def max_rel_gap(got, want) -> float:
    """The largest `rel_gap` over paired readings."""
    return max(rel_gap(g, w) for g, w in zip(got, want, strict=True))


def procrustes_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got Q - want||_F / ||want||_F for the orthogonal Q that fits got to
    want best: an embedding is defined up to rotation and reflection, and
    the spectral start's eigenvectors up to their signs."""
    a, b = got.double(), want.double()
    u, _, vh = torch.linalg.svd(a.T @ b)
    q = u @ vh
    return float(torch.linalg.norm(a @ q - b) / torch.linalg.norm(b))
