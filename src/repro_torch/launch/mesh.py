"""Meshes over a `torch.distributed` process group.

Port of the parts of `repro/launch/mesh.py` that the row-sharded sparse
backend (sparse/sharding.py) uses.  JAX names the devices of one program
with mesh axes; here every device is a rank of its own process, and a
`Mesh` names the ranks of a process group the same way: axis names with
their sizes, laid over the ranks in row-major order, so that the shape
``{"data": world, "model": 1}`` puts every rank on the row axis.

The package never starts a process group itself.  The caller or its
launcher does, as `torchrun` does:

    torch.distributed.init_process_group("nccl")     # one rank per GPU
    mesh = make_host_mesh()                          # {"data": world, "model": 1}
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch.distributed as dist


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            "a Mesh names the ranks of a torch.distributed process group, "
            "and none is started: call torch.distributed.init_process_group "
            "first (one process per rank, e.g. under torchrun; backend "
            "'nccl' for one GPU a rank, 'gloo' on the CPU)")


def world_size() -> int:
    """Ranks of the default process group; 1 when none is started."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of a process group (the default group
    when `group` is None).  The axes' sizes must multiply to the group's
    size; `rank` is this process's rank in the group."""

    shape: Mapping[str, int]
    group: dist.ProcessGroup | None = None
    rank: int = dataclasses.field(init=False)

    def __post_init__(self):
        _require_group()
        shape = dict(self.shape)
        if any(s < 1 for s in shape.values()):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        size = dist.get_world_size(self.group)
        if math.prod(shape.values()) != size:
            raise ValueError(f"mesh shape {shape} has "
                             f"{math.prod(shape.values())} ranks; the process "
                             f"group has {size}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "rank", dist.get_rank(self.group))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def linear_row_index(mesh: Mesh, row_axes: tuple[str, ...]) -> int:
    """Linear (row-major) index of this rank across `row_axes`: its block
    of a layout sharded over those axes.  Where every other axis has size 1
    (all the sparse backend accepts) it is the rank."""
    coords, rest = {}, mesh.rank
    for ax in reversed(mesh.axis_names):
        rest, coords[ax] = divmod(rest, mesh.shape[ax])
    idx = 0
    for ax in row_axes:
        idx = idx * mesh.shape[ax] + coords[ax]
    return idx


def make_host_mesh() -> Mesh:
    """The default process group as ("data", "model") with every rank on
    "data" (the row axis).  Raises when no group is started."""
    _require_group()
    return Mesh({"data": world_size(), "model": 1})
