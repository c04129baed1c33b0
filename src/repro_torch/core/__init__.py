# The generic attraction-repulsion embedding objective (dense and sparse
# halves) and the paper's dense partial-Hessian strategies, ported to
# PyTorch.
from .affinities import Affinities, make_affinities, sq_distances
from .linesearch import LSConfig
from .objectives import (
    NORMALIZED,
    attractive_weights,
    direct_energy,
    draw_shifts,
    energy,
    energy_and_grad,
    energy_and_grad_sparse,
    grad,
    gradient_weights,
    is_normalized,
)
from .spectral_init import laplacian_eigenmaps
from .strategies import FP, GD, SD

__all__ = [
    "Affinities", "make_affinities", "sq_distances", "LSConfig",
    "NORMALIZED", "attractive_weights", "direct_energy", "draw_shifts",
    "energy", "energy_and_grad", "energy_and_grad_sparse", "grad",
    "gradient_weights", "is_normalized",
    "laplacian_eigenmaps", "FP", "GD", "SD",
]
