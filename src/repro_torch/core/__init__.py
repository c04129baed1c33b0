# The generic attraction-repulsion embedding objective (dense and sparse
# halves), the paper's partial-Hessian strategies and its baselines
# (L-BFGS, nonlinear CG), the dense minimizer and the homotopy path, ported to
# PyTorch.
from .affinities import (
    Affinities,
    make_affinities,
    sne_affinities,
    sne_affinities_from_d2,
    sq_distances,
)
from .baselines import LBFGS, NonlinearCG
from .homotopy import HomotopyResult, homotopy_path
from .linesearch import LSConfig
from .minimize import MinimizeResult
from .objectives import (
    NORMALIZED,
    attractive_edge_terms,
    attractive_weights,
    direct_energy,
    draw_shifts,
    energy,
    energy_and_grad,
    energy_and_grad_sparse,
    grad,
    gradient_weights,
    is_normalized,
    negative_pair_terms,
)
from .spectral_init import laplacian_eigenmaps
from .strategies import FP, GD, SD, DiagH, SDMinus, SparseSD, make_strategy

__all__ = [
    "Affinities", "make_affinities", "sne_affinities",
    "sne_affinities_from_d2", "sq_distances",
    "LBFGS", "NonlinearCG", "HomotopyResult", "homotopy_path",
    "LSConfig", "MinimizeResult",
    "NORMALIZED", "attractive_edge_terms", "attractive_weights",
    "direct_energy", "draw_shifts", "energy", "energy_and_grad",
    "energy_and_grad_sparse", "grad", "gradient_weights", "is_normalized",
    "negative_pair_terms",
    "laplacian_eigenmaps",
    "DiagH", "FP", "GD", "SD", "SDMinus", "SparseSD", "make_strategy",
]
