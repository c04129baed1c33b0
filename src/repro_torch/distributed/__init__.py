# Logical-axis sharding rules over the process-group meshes of
# launch/mesh.py (distributed/sharding.py).
from .sharding import (NamedSharding, PartitionSpec, batch_shardings,
                       fsdp_axes, opt_state_shardings, scalar_sharding,
                       spec_for, tree_shardings)

__all__ = ["NamedSharding", "PartitionSpec", "batch_shardings", "fsdp_axes",
           "opt_state_shardings", "scalar_sharding", "spec_for",
           "tree_shardings"]
