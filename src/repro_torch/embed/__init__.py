from .distributed import (
    EmbedMeshSpec,
    make_block_jacobi_setup,
    make_block_jacobi_solve,
    make_distributed_energy_grad,
    replicate,
    shard_pairwise,
    shard_rows,
)
from .engine import EngineResult, LoopConfig, Objective, fit_loop

__all__ = [
    "EmbedMeshSpec", "make_block_jacobi_setup", "make_block_jacobi_solve",
    "make_distributed_energy_grad", "replicate", "shard_pairwise",
    "shard_rows", "EngineResult", "LoopConfig", "Objective", "fit_loop",
]
