# The hand-written CUDA kernels for Hopper: the fused O(N^2 d) pairwise
# terms of the dense path (csrc/pairwise.cu, wrapped in pairwise.py), the
# directed ELL Laplacian gather of the sparse path (csrc/ell.cu, wrapped in
# sparse_attractive.py) and the Barnes-Hut cell interaction of the tree path
# (csrc/farfield.cu, wrapped in farfield.py), their plain PyTorch oracles
# (ref.py), the dispatch layer (ops.py) and the at-first-dispatch launch
# shape autotuner (autotune.py).  Nothing is compiled at import;
# _build.py compiles the CUDA sources at first launch.
from . import autotune, ops, ref
from .autotune import KernelConfig
from .ops import last_dispatch
from .ref import KINDS, PairwiseTerms, ell_lap_matvec_ref

__all__ = ["autotune", "ops", "ref", "KernelConfig", "last_dispatch",
           "KINDS", "PairwiseTerms", "ell_lap_matvec_ref"]
