# Sparse neighbour-graph subsystem: the O(N k) attractive side of large-N
# embeddings.  ELL (padded neighbour-list) storage, perplexity calibration
# over k candidates, sparse Laplacian operators and preconditioned CG; the
# directed Laplacian gathers run on the CUDA kernel of kernels/csrc/ell.cu.
# The deterministic Barnes-Hut far field (farfield.py) is the repulsive side
# of the tree backend; its cell interaction runs on kernels/csrc/farfield.cu.
# The row-sharded backend (sharding.py) splits the graph's rows over the
# ranks of a torch.distributed process group; its local-rows products run on
# the local-rows kernel of kernels/csrc/ell.cu.  Port of repro.sparse.
from .farfield import (
    GridPlan,
    energy_and_grad_tree,
    make_grid_plan,
    tree_diagnostics,
    tree_repulsion,
)
from .graph import (
    NeighborGraph,
    SparseAffinities,
    calibrated_weights_ell,
    from_dense,
    knn_cross,
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
from .sharding import (
    ShardedSparseGraph,
    make_sharded_energy_grad,
    make_sharded_sd_operator,
    shard_sparse_affinities,
    validate_sparse_mesh,
)

__all__ = [
    "NeighborGraph", "SparseAffinities", "calibrated_weights_ell",
    "from_dense", "knn_cross", "knn_graph", "knn_graph_approx",
    "knn_graph_exact", "reverse_graph", "sparse_affinities", "to_dense",
    "ell_matvec", "ell_t_matvec", "in_degree", "make_sd_operator",
    "out_degree", "pcg", "sparse_laplacian_eigenmaps", "sym_degree",
    "sym_lap_matvec", "sym_matvec",
    "GridPlan", "make_grid_plan", "tree_repulsion", "energy_and_grad_tree",
    "tree_diagnostics",
    "ShardedSparseGraph", "validate_sparse_mesh", "shard_sparse_affinities",
    "make_sharded_energy_grad", "make_sharded_sd_operator",
]
