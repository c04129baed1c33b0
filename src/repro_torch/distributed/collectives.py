"""Collectives of the sharded train step, as autograd functions over a
mesh's axis groups, each with its conjugate backward.

The reference lowers its train step under explicit shardings and GSPMD
inserts the collectives.  The eager port issues them itself, as Megatron
does, with the backward each forward implies:

  =====================  ==========================  ========================
  function               forward                     backward
  =====================  ==========================  ========================
  `gather`               all-gather along a dim      reduce-scatter (sum)
  `copy_to`              identity                    all-reduce (sum)
  `reduce_from`          all-reduce (sum)            identity
  `gather_from`          all-gather along a dim      this rank's slice
  `scatter_to`           this rank's slice           all-gather
  `reduce_scatter_from`  reduce-scatter along a dim  all-gather
  `psum`                 all-reduce (sum)            all-reduce (sum)
  =====================  ==========================  ========================

`gather` feeds compute that each rank does on its own part (a param block
gathered over the FSDP axes: the ranks' gradients differ and are summed
onto the blocks); `gather_from` feeds compute that every rank of the group
repeats (its gradient is the same on every rank, so a rank keeps its
slice).  `copy_to` / `reduce_from` are Megatron's f / g pair around a
column- and a row-parallel matmul.  `reduce_scatter_from` sums partial
products onto this rank's slice of their columns (RWKV6's channel mix,
whose gate is column-parallel); `psum` is a sum that every rank reads for
its own part alone (Mamba2's RMSNorm over d_inner: each rank's gradient of
the sum covers its columns, so the backward sums them too).

`TensorParallel` binds them to a mesh: the FSDP group (`fsdp_axes`) and the
"model" group, and the params' `NamedSharding` tree.  `gather_params`
turns a subtree of this rank's blocks into what the layers compute with:
each leaf gathered over the FSDP axes and, where it is split over "model",
left as its "model" block and marked with the dim that is split
(`model_split`: attention's heads, the MLPs' hidden units, the MoE
layers' experts or hidden units, the vision cross-attention's heads, the
SSM mixers' heads), or, for `whole` subtrees (compute that every rank of
"model" repeats: an SSM mixer whose heads do not divide over "model"; the
MoE load-balance loss's router), gathered over "model" too.  A leaf
the spec leaves whole on the FSDP axes is held the same on each FSDP rank;
its gradient is summed there (`copy_to`).

Every collective is one call of the process group on contiguous buffers:
no atomics, and the reduction order is the backend's for the group, fixed
for a mesh.  A group of one rank issues nothing: on a mesh whose axes are
all of size 1 every function is the identity (the same tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import flatten

from .sharding import NamedSharding, _entry_axes, fsdp_axes

@dataclasses.dataclass(frozen=True)
class Axis:
    """The ranks of one collective: their process group (None for one
    rank), their count and this rank's place among them (the order of the
    blocks that a gather concatenates)."""

    group: Any
    size: int
    index: int


ONE = Axis(None, 1, 0)


def mesh_axis(mesh, axes: tuple[str, ...]) -> Axis:
    """The ranks that differ from this one only on `axes` (ascending, which
    is the row-major order of the axes' coordinates)."""
    axes = tuple(a for a in axes if a in mesh.axis_names)
    if all(mesh.shape[a] == 1 for a in axes):
        return ONE
    ag = mesh.axis_group(axes)
    return Axis(ag.group, ag.size, ag.ranks.index(mesh.rank))


# -- the collectives on plain tensors ---------------------------------------------


def all_gather(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, in their order."""
    dim %= x.ndim
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((ax.size * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=ax.group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's slice along `dim` of the ranks' sum of `x`."""
    dim %= x.ndim
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // ax.size,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=ax.group)
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, ax: Axis,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The ranks' reduction of `x` (a new tensor; `x` is left as it is)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=ax.group)
    return out


def local_slice(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's block of `x` along `dim` (a copy of its own)."""
    size = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * size, size).contiguous()


# -- the autograd functions ----------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.ax), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.dim, ctx.ax), None, None


class _ReduceScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return reduce_scatter(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return local_slice(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.ax), None, None


def gather(x, dim: int, ax: Axis):
    """All-gather along `dim` forward, reduce-scatter backward."""
    return x if ax.size == 1 else _Gather.apply(x, dim % x.ndim, ax)


def copy_to(x, ax: Axis):
    """Identity forward, all-reduce of the gradient backward."""
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from(x, ax: Axis):
    """All-reduce forward, identity backward."""
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_from(x, dim: int, ax: Axis):
    """All-gather along `dim` forward, this rank's slice backward."""
    return x if ax.size == 1 else _GatherFrom.apply(x, dim % x.ndim, ax)


def scatter_to(x, dim: int, ax: Axis):
    """This rank's slice along `dim` forward, all-gather backward."""
    return x if ax.size == 1 else _ScatterTo.apply(x, dim % x.ndim, ax)


def reduce_scatter_from(x, dim: int, ax: Axis):
    """This rank's slice along `dim` of the ranks' sum forward, all-gather
    backward."""
    return x if ax.size == 1 else _ReduceScatterFrom.apply(x, dim % x.ndim,
                                                           ax)


def psum(x, ax: Axis):
    """All-reduce (sum) forward and backward."""
    return x if ax.size == 1 else _Psum.apply(x, ax)


# -- which dim of a tensor is split over "model" ---------------------------------------

_SPLIT = "_model_split"


def mark(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """Record on `x` the dim that is split over "model" (None: whole)."""
    setattr(x, _SPLIT, None if dim is None else dim % x.ndim)
    return x


def is_marked(x) -> bool:
    """Whether tensor-parallel code recorded `x`'s layout (`mark`)."""
    return hasattr(x, _SPLIT)


def model_split(x) -> int | None:
    """The dim of `x` that is split over "model", as `mark` recorded it;
    None for a tensor that is whole on "model" (every unmarked one)."""
    return getattr(x, _SPLIT, None)


# -- the step's view of a mesh ---------------------------------------------------------


def split_dims(sh: NamedSharding, ndim: int, fsdp: tuple[str, ...]):
    """(the dim split over the FSDP axes, the dim split over "model") of a
    leaf's spec, None where none is or the axes are of size 1."""
    fdim = mdim = None
    for d in range(ndim):
        axes = [a for a in _entry_axes(sh.spec[d] if d < len(sh.spec)
                                       else None)
                if sh.mesh.shape[a] > 1]
        if axes and set(axes) <= set(fsdp):
            fdim = d
        elif axes == ["model"]:
            mdim = d
        elif axes:
            raise ValueError(f"spec {sh.spec} splits dim {d} over {axes}: "
                             f"neither the FSDP axes {fsdp} nor 'model'")
    return fdim, mdim


class TensorParallel:
    """The sharded step's view of `mesh`: its FSDP group, its "model"
    group and the params' `NamedSharding` tree (`shardings`, the params'
    structure), whose blocks the step holds."""

    def __init__(self, mesh, shardings):
        fa = fsdp_axes(mesh)
        if fa != tuple(a for a in mesh.axis_names if a in fa):
            raise ValueError(f"the FSDP axes {fa} must come in the mesh's "
                             f"order {mesh.axis_names}")
        self.mesh = mesh
        self.shardings = shardings
        self.fsdp_axes = fa
        self.fsdp = mesh_axis(mesh, fa)
        self.model = mesh_axis(mesh, ("model",))

    # the "model" group's collectives on activations
    def copy_to_model(self, x):
        return copy_to(x, self.model)

    def reduce_from_model(self, x):
        return reduce_from(x, self.model)

    def gather_from_model(self, x, dim: int):
        return mark(gather_from(x, dim, self.model), None)

    def scatter_to_model(self, x, dim: int):
        return mark(scatter_to(x, dim, self.model), dim)

    def reduce_scatter_from_model(self, x, dim: int):
        return mark(reduce_scatter_from(x, dim, self.model), dim)

    def psum_model(self, x):
        return psum(x, self.model)

    def gather_over_model(self, x, dim: int):
        """`gather` over "model": for an activation that split compute
        reads whole (each rank's gradient of it differs)."""
        return mark(gather(x, dim, self.model), None)

    def max_over_model(self, x):
        """The elementwise max over the "model" group (no gradient)."""
        if self.model.size == 1:
            return x
        return all_reduce(x.detach(), self.model, dist.ReduceOp.MAX)

    def gather_params(self, params, shardings, *, layers: bool = False,
                      whole: bool = False):
        """The tensors a rank computes with from its blocks `params` (a
        subtree) and their `shardings`: each leaf gathered over the FSDP
        axes (reduce-scattered back in the backward) and kept as its
        "model" block, marked, or, with `whole` (compute that every rank of
        "model" repeats: an SSM mixer whose heads do not divide over
        "model", the MoE load-balance loss's router), gathered over
        "model" too (`gather_from`).
        `layers`: the blocks are one layer group's, selected from stacked
        leaves whose specs begin with the unsplit "layers" dim."""
        flat, rebuild, _ = flatten(params)
        shs, _, _ = flatten(shardings)
        return rebuild([self._leaf(p, s, layers, whole)
                        for p, s in zip(flat, shs)])

    def _leaf(self, block, sh: NamedSharding, layers: bool, whole: bool):
        ndim = block.ndim + (1 if layers else 0)
        fdim, mdim = split_dims(sh, ndim, self.fsdp_axes)
        if layers:
            if 0 in (fdim, mdim):
                raise ValueError(f"a stacked leaf split on its layers dim: "
                                 f"{sh.spec}")
            fdim = None if fdim is None else fdim - 1
            mdim = None if mdim is None else mdim - 1
        x = (gather(block, fdim, self.fsdp) if fdim is not None
             else copy_to(block, self.fsdp))
        if mdim is not None and whole:
            return mark(gather_from(x, mdim, self.model), None)
        return mark(x, mdim)
