"""Kernel-function algebra for the generic embedding formulation (paper §1).

Port of `repro/core/kernels_fn.py`.  A kernel is a positive decreasing
scalar function K(t) of the squared distance t = ||x_n - x_m||^2 >= 0.  The
paper's Hessian analysis is driven by four derived scalar functions:

    K1  = (log K)' = K'/K
    K2  = K''/K
    K21 = (log K)'' = K2 - K1^2

Gaussian (s-SNE, EE):      K = exp(-t),   K1 = -1,  K2 = 1,     K21 = 0
Student-t (t-SNE):         K = 1/(1+t),   K1 = -K,  K2 = 2K^2,  K21 = K^2
Epanechnikov (extension):  K = max(1-t,0) on its support, K2 = 0

The functions with K21 = 0 or K2 = 0 yield the simplest Hessians (paper fn.1)
— exactly the Gaussian and Epanechnikov kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A positive decreasing kernel K(t), t >= 0, with derived quantities."""

    name: str
    K: Callable[[Tensor], Tensor]
    K1: Callable[[Tensor], Tensor]   # (log K)'
    K2: Callable[[Tensor], Tensor]   # K''/K
    K21: Callable[[Tensor], Tensor]  # (log K)''


GAUSSIAN = Kernel(
    name="gaussian",
    K=lambda t: torch.exp(-t),
    K1=lambda t: -torch.ones_like(t),
    K2=lambda t: torch.ones_like(t),
    K21=lambda t: torch.zeros_like(t),
)

STUDENT_T = Kernel(
    name="student_t",
    K=lambda t: 1.0 / (1.0 + t),
    K1=lambda t: -1.0 / (1.0 + t),
    K2=lambda t: 2.0 / (1.0 + t) ** 2,
    K21=lambda t: 1.0 / (1.0 + t) ** 2,
)

# Epanechnikov: finite support.  K1/K21 are defined on the support only;
# outside it they are masked to 0, and the denominator is clamped away from
# zero so that no inf is formed on the support's edge.
_EPS = 1e-12

EPANECHNIKOV = Kernel(
    name="epanechnikov",
    K=lambda t: torch.clamp_min(1.0 - t, 0.0),
    K1=lambda t: torch.where(t < 1.0, -1.0 / torch.clamp_min(1.0 - t, _EPS),
                             0.0),
    K2=lambda t: torch.zeros_like(t),
    K21=lambda t: torch.where(
        t < 1.0, -1.0 / torch.clamp_min(1.0 - t, _EPS) ** 2, 0.0),
)

KERNELS = {k.name: k for k in (GAUSSIAN, STUDENT_T, EPANECHNIKOV)}


def get_kernel(name: str) -> Kernel:
    try:
        return KERNELS[name]
    except KeyError:
        raise ValueError(f"unknown kernel {name!r}; have {sorted(KERNELS)}")
