# The fused O(N^2 d) pairwise kernel of the paper's hot spot: a hand-written
# CUDA kernel for Hopper (csrc/pairwise.cu, wrapped in pairwise.py), its
# plain PyTorch oracle (ref.py) and the dispatch layer (ops.py).  Nothing is
# compiled at import; _build.py compiles the CUDA sources at first launch.
from . import ops, ref
from .ops import last_dispatch
from .ref import KINDS, PairwiseTerms

__all__ = ["ops", "ref", "last_dispatch", "KINDS", "PairwiseTerms"]
