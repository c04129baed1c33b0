# Sparse neighbour-graph subsystem: the O(N k) attractive side of large-N
# embeddings.  ELL (padded neighbour-list) storage, perplexity calibration
# over k candidates, sparse Laplacian operators and preconditioned CG; the
# directed Laplacian gathers run on the CUDA kernel of kernels/csrc/ell.cu.
# Port of repro.sparse for the single-device backend (the Barnes-Hut far
# field and the row-sharded backend are not ported yet).
from .graph import (
    NeighborGraph,
    SparseAffinities,
    calibrated_weights_ell,
    from_dense,
    knn_graph,
    knn_graph_approx,
    knn_graph_exact,
    reverse_graph,
    sparse_affinities,
    to_dense,
)
from .linalg import (
    ell_matvec,
    ell_t_matvec,
    in_degree,
    make_sd_operator,
    out_degree,
    pcg,
    sparse_laplacian_eigenmaps,
    sym_degree,
    sym_lap_matvec,
    sym_matvec,
)

__all__ = [
    "NeighborGraph", "SparseAffinities", "calibrated_weights_ell",
    "from_dense", "knn_graph", "knn_graph_approx", "knn_graph_exact",
    "reverse_graph", "sparse_affinities", "to_dense",
    "ell_matvec", "ell_t_matvec", "in_degree", "make_sd_operator",
    "out_degree", "pcg", "sparse_laplacian_eigenmaps", "sym_degree",
    "sym_lap_matvec", "sym_matvec",
]
