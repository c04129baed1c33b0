# Process-group meshes for the multi-GPU backends (launch/mesh.py).
from .mesh import (AxisGroup, Mesh, linear_row_index, make_host_mesh,
                   make_production_mesh, n_chips, world_size)

__all__ = ["AxisGroup", "Mesh", "linear_row_index", "make_host_mesh",
           "make_production_mesh", "n_chips", "world_size"]
