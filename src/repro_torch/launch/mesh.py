"""Meshes over a `torch.distributed` process group.

Port of the parts of `repro/launch/mesh.py` that the mesh backends use
(sparse/sharding.py, embed/distributed.py).  JAX names the devices of one
program with mesh axes; here every device is a rank of its own process, and
a `Mesh` names the ranks of the default process group the same way: axis
names with their sizes, laid over the ranks in row-major order, so that the
shape ``{"data": 2, "model": 2}`` puts ranks 0 and 1 on data row 0 (model
coordinates 0 and 1) and ranks 2 and 3 on data row 1.

Where a JAX collective names axes (``psum(x, "model")``), a rank here sums
over the process group of the ranks that share its coordinates on every
other axis: `Mesh.axis_group(("model",))`.  `torch.distributed.new_group` is
collective over the default group, so a Mesh builds the group of every
proper subset of its axes once, when it is made, in one order on every
rank; every rank makes the same Mesh.  A class of one rank needs no group
and a class of every rank is the default group, so a mesh with one axis
wider than 1 (the sparse backend's) makes none.

The package never starts a process group itself.  The caller or its
launcher does, as `torchrun` does:

    torch.distributed.init_process_group("nccl")     # one rank per GPU
    mesh = make_host_mesh()                          # {"data": world, "model": 1}
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Mapping, NamedTuple

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


class AxisGroup(NamedTuple):
    """The ranks that share this rank's coordinates off some axes, in
    ascending order (a process group's own order), and their process group:
    None for a class of one rank (no collective needed)."""

    ranks: tuple[int, ...]
    group: dist.ProcessGroup | None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks of the default process group.  The axes'
    sizes must multiply to the group's size; `rank` is this process's rank
    and `coords` its coordinate on each axis.  Making a Mesh is collective:
    every rank makes the same one, in the same order."""

    shape: Mapping[str, int]
    rank: int = dataclasses.field(init=False)

    def __post_init__(self):
        _require_group()
        shape = dict(self.shape)
        if any(s < 1 for s in shape.values()):
            raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
        size = dist.get_world_size()
        if math.prod(shape.values()) != size:
            raise ValueError(f"mesh shape {shape} has "
                             f"{math.prod(shape.values())} ranks; the process "
                             f"group has {size}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "rank", dist.get_rank())
        object.__setattr__(self, "_groups", self._axis_groups())

    def _axis_groups(self) -> dict:
        """{axes: AxisGroup} for every proper non-empty subset of the axes
        (in the mesh's order), built in one order on every rank."""
        names = self.axis_names
        every = [self.coords_of(r) for r in range(self.size)]
        groups = {}
        for k in range(1, len(names)):
            for axes in itertools.combinations(names, k):
                fixed = [ax for ax in names if ax not in axes]
                classes: dict[tuple, list[int]] = {}
                for r, c in enumerate(every):
                    classes.setdefault(tuple(c[ax] for ax in fixed),
                                       []).append(r)
                mine = tuple(every[self.rank][ax] for ax in fixed)
                width = math.prod(self.shape[ax] for ax in axes)
                if width == 1:
                    group = None
                elif width == self.size:
                    group = dist.group.WORLD
                else:
                    for key, ranks in classes.items():
                        g = dist.new_group(ranks)    # collective: every rank
                        if key == mine:
                            group = g
                groups[axes] = AxisGroup(tuple(classes[mine]), group)
        return groups

    def coords_of(self, rank: int) -> dict[str, int]:
        """A rank's coordinate on each axis (row-major over the axes)."""
        coords, rest = {}, rank
        for ax in reversed(self.axis_names):
            rest, coords[ax] = divmod(rest, self.shape[ax])
        return {ax: coords[ax] for ax in self.axis_names}

    @property
    def group(self) -> None:
        """The process group of every axis: the default group, which
        `torch.distributed`'s collectives name None."""
        return None

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate on each axis."""
        return self.coords_of(self.rank)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_group(self, axes) -> AxisGroup:
        """The ranks that differ from this one only on `axes` (in any
        order: the counterpart of a JAX collective over those axes) and
        their process group; raises for an axis the mesh lacks."""
        for ax in axes:
            if ax not in self.shape:
                raise ValueError(f"axis {ax!r} not in mesh axes "
                                 f"{self.axis_names}")
        axes = tuple(ax for ax in self.axis_names if ax in axes)
        if len(axes) == len(self.axis_names):
            return AxisGroup(tuple(range(self.size)),
                             dist.group.WORLD if self.size > 1 else None)
        if not axes:
            return AxisGroup((self.rank,), None)
        return self._groups[axes]


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


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """The default process group as ("data", "model"): world / model_axis
    rows of `model_axis` ranks.  Raises when no group is started or when
    `model_axis` does not divide the group's size."""
    _require_group()
    n = world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the "
                         f"process group's {n} ranks")
    return Mesh({"data": n // model_axis, "model": model_axis})
