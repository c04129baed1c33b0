# Process-group meshes for the multi-GPU backends (launch/mesh.py).
from .mesh import (AxisGroup, Mesh, linear_row_index, make_host_mesh,
                   world_size)

__all__ = ["AxisGroup", "Mesh", "linear_row_index", "make_host_mesh",
           "world_size"]
