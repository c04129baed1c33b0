# The generic attraction-repulsion embedding objective and the
# partial-Hessian strategies of the paper (dense half), ported to PyTorch.
from .affinities import Affinities, make_affinities, sq_distances
from .linesearch import LSConfig
from .objectives import (
    NORMALIZED,
    attractive_weights,
    direct_energy,
    energy,
    energy_and_grad,
    grad,
    gradient_weights,
    is_normalized,
)
from .spectral_init import laplacian_eigenmaps
from .strategies import FP, GD, SD

__all__ = [
    "Affinities", "make_affinities", "sq_distances", "LSConfig",
    "NORMALIZED", "attractive_weights", "direct_energy", "energy",
    "energy_and_grad", "grad", "gradient_weights", "is_normalized",
    "laplacian_eigenmaps", "FP", "GD", "SD",
]
