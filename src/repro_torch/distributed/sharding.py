"""Logical-axis -> mesh-axis sharding rules.

Port of `repro/distributed/sharding.py`.  Parameters and caches carry
LOGICAL axis names (the `axes` trees of `Model.init_params` and
`Model.cache_axes`); this module maps them onto a mesh:

  embed            -> FSDP axes ("pod","data" when present, else "data")
  mlp / q_heads / kv_heads / vocab / experts / ssm_proj / ssm_heads -> "model"
  layers / scalars -> unsharded

A dim is only sharded if its size is divisible by the mesh axis size and the
axis is not already used by an earlier dim of the same tensor, as the
reference's rules say.  The rules read only a mesh's axis names and sizes
(`mesh.axis_names`, `mesh.shape`), so any object with those two serves:
a test can ask for the production shapes without 256 ranks.

JAX places a sharded array through GSPMD.  Here a sharding is the pair
(mesh, spec), `NamedSharding`, over `launch.mesh.Mesh`'s ranks: it cuts a
whole tensor into this rank's block (`shard`, by the mesh's row-major
coordinates, as JAX lays a `PartitionSpec` over its devices) and gathers
the blocks back (`gather`, one all-gather over `Mesh.axis_group` of the
axes it names).  The sharded train step (`models/train.py`) keeps params,
moments and gradients as such blocks.

`make_activation_constraint` re-lays q, k and v over "model" to the
reference's activation spec when the sharded step's tensor-parallel
context (`collectives.TensorParallel`, the autograd collectives the step
and the layers issue) is passed to it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import flatten, tree_map

# candidate mesh axes per logical axis, in priority order; "fsdp" expands
RULES: dict[str | None, tuple[str, ...]] = {
    "embed": ("fsdp",),
    "embed_act": ("model",),
    "mlp": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "kv_seq": ("model",),   # fallback: sequence-sharded KV cache (below)
    "vocab": ("model",),
    "experts": ("model",),
    "experts_r": ("model",),
    "ssm_proj": ("model",),
    "ssm_heads": ("model",),
    "codebooks": (),
    "layers": (),
    "batch": ("fsdp",),
    None: (),
}

# assignment order within one tensor: kv_heads gets first claim on the
# model axis; kv_seq only takes it when the head count doesn't divide
_PRIORITY: dict[str | None, int] = {"kv_heads": 0, "experts": 0,
                                    "kv_seq": 2}


class PartitionSpec(tuple):
    """`jax.sharding.PartitionSpec`: per dim None (whole), a mesh axis name,
    or a tuple of names (the dim split over their product, the first
    major; a tuple of one name is that name, as JAX normalizes it).  Dims
    past the spec's length are whole."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __getnewargs__(self):
        # pickle rebuilds it from its parts, as it was made
        return tuple(self)


P = PartitionSpec


def fsdp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis_size(mesh, axis: str | tuple[str, ...]) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement: `spec` over `mesh`.  `shard` and `gather` need
    a `launch.mesh.Mesh` (a process group); the rules only its shape."""

    mesh: Any
    spec: PartitionSpec

    @property
    def axes(self) -> tuple[str, ...]:
        """The mesh axes the spec names, in the mesh's order."""
        named = {a for e in self.spec for a in _entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in named)

    @property
    def is_whole(self) -> bool:
        """Every rank holds the whole tensor: no named axis wider than 1."""
        return all(self.mesh.shape[a] == 1 for a in self.axes)

    def _slices(self, shape, coords: dict) -> tuple:
        """The index of the block at mesh `coords` in a whole tensor of
        `shape`: a slice a dim."""
        out = []
        for dim, size in enumerate(shape):
            axes = _entry_axes(self.spec[dim] if dim < len(self.spec)
                               else None)
            count, idx = 1, 0
            for a in axes:
                count *= self.mesh.shape[a]
                idx = idx * self.mesh.shape[a] + coords[a]
            if size % count:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"{count} ways ({self.spec})")
            step = size // count
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)

    def local_view(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor `x`, as a view of it."""
        if self.is_whole:
            return x
        return x[self._slices(x.shape, self.mesh.coords)]

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor `x`, in memory of its own
        (`x` itself when the rank holds the whole)."""
        if self.is_whole:
            return x
        return self.local_view(x).clone()

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's `block`: one all-gather over
        the ranks that differ from this one on the spec's axes (every rank
        of that group calls it).  `block` itself when the rank holds the
        whole."""
        if self.is_whole:
            return block
        group = self.mesh.axis_group(self.axes)
        parts = [torch.empty_like(block) for _ in group.ranks]
        dist.all_gather(parts, block.contiguous(), group=group.group)
        shape = tuple(
            n * math.prod(self.mesh.shape[a] for a in _entry_axes(
                self.spec[d] if d < len(self.spec) else None))
            for d, n in enumerate(block.shape))
        out = block.new_empty(shape)
        for rank, part in zip(group.ranks, parts):
            out[self._slices(shape, self.mesh.coords_of(rank))] = part
        return out


def spec_for(mesh, logical: tuple, shape: tuple) -> PartitionSpec:
    """PartitionSpec for one tensor given its logical axes and shape.
    Dims are assigned in _PRIORITY order (not positional order), so
    fallback axes only claim a mesh axis the primary owner couldn't use."""
    used: set[str] = set()
    out: list = [None] * len(logical)
    order = sorted(range(len(logical)),
                   key=lambda i: (_PRIORITY.get(logical[i], 1), i))
    for i in order:
        dim, name = shape[i], logical[i]
        cands = RULES.get(name, ())
        for cand in cands:
            mesh_axis: str | tuple[str, ...]
            mesh_axis = fsdp_axes(mesh) if cand == "fsdp" else cand
            if not mesh_axis:
                continue
            flat = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
            if any(a in used or a not in mesh.axis_names for a in flat):
                continue
            if dim % _axis_size(mesh, mesh_axis) != 0:
                continue
            out[i] = mesh_axis
            used.update(flat)
            break
    return P(*out)


def _axes_leaves(tree) -> list:
    """`jax.tree.leaves(axes_tree, is_leaf=lambda x: isinstance(x,
    tuple))`: the logical-axes tuples in flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _axes_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _axes_leaves(v)]
    if tree is None:
        return []
    return [tree]


def tree_shardings(mesh, axes_tree: Any, shape_tree: Any) -> Any:
    """NamedSharding tree matching `shape_tree` (tensors, `meta` tensors or
    anything with a `.shape`)."""
    flat_axes = _axes_leaves(axes_tree)
    flat_shapes, rebuild, _ = flatten(shape_tree)
    if len(flat_axes) != len(flat_shapes):
        raise ValueError(f"axes tree has {len(flat_axes)} leaves, shape "
                         f"tree {len(flat_shapes)}")
    return rebuild([NamedSharding(mesh, spec_for(mesh, ax, tuple(s.shape)))
                    for ax, s in zip(flat_axes, flat_shapes)])


def batch_shardings(mesh, batch_tree: Any) -> Any:
    """Shard the leading (batch) dim over the FSDP axes where divisible."""
    fa = fsdp_axes(mesh)
    size = _axis_size(mesh, fa) if fa else 1

    def one(x):
        shape = tuple(x.shape)
        if fa and shape and shape[0] % size == 0:
            return NamedSharding(mesh, P(fa))
        return NamedSharding(mesh, P())

    return tree_map(one, batch_tree)


def batch_rows(mesh, batch: dict) -> dict:
    """This rank's rows of every leaf of a global batch (views), by
    `batch_shardings`."""
    sh = batch_shardings(mesh, batch)
    return {k: sh[k].local_view(v) for k, v in batch.items()}


def scalar_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def opt_state_shardings(mesh, axes_tree: Any, params_shapes: Any) -> Any:
    """Adam m/v share the parameter sharding; count is replicated."""
    ps = tree_shardings(mesh, axes_tree, params_shapes)
    return {"m": ps, "v": ps, "count": scalar_sharding(mesh)}


def activation_spec(mesh, shape: tuple, tag: str,
                    shard_embed: bool = False) -> PartitionSpec:
    """The reference's constraint on an activation of `shape` at `tag`:
    the leading batch dim over the FSDP axes and, where divisible, heads
    (qkv), d_model (residual, with `shard_embed`) or the experts / capacity
    (the MoE dispatch) over "model"."""
    fa = fsdp_axes(mesh)
    fsize = _axis_size(mesh, fa) if fa else 1
    msize = mesh.shape.get("model", 1)
    ndim = len(shape)
    has_model = "model" in mesh.axis_names
    spec: list = [None] * ndim
    if fa and shape[0] % fsize == 0:
        spec[0] = fa
    if tag == "qkv" and ndim == 4 and has_model and shape[2] % msize == 0:
        spec[2] = "model"
    if tag == "residual" and shard_embed and has_model \
            and shape[-1] % msize == 0:
        spec[-1] = "model"
    if tag == "moe_dispatch" and ndim == 4 and has_model:
        # (B, S, E, C): experts over model (EP); if the expert count does
        # not divide, the capacity dim instead
        if shape[2] % msize == 0:
            spec[2] = "model"
        elif shape[3] % msize == 0:
            spec[3] = "model"
    if tag == "moe_expert" and ndim == 4 and has_model:
        spec = [None] * 4   # (E, B, C, D)
        if shape[0] % msize == 0:
            spec[0] = "model"
        elif shape[2] % msize == 0:
            spec[2] = "model"
        if fa and shape[1] % fsize == 0:
            spec[1] = fa
    return P(*spec)


def make_activation_constraint(mesh, run=None):
    """Constraint hook for the residual stream / QKV activations and the
    MoE dispatch (models/hooks.py).  Called with the sharded step's
    `collectives.TensorParallel` (`tp`), it re-lays q, k or v ("qkv") over
    "model" to the reference's spec (`activation_spec`): it gathers the
    heads when they leave "model" and keeps this rank's heads when they
    enter it (the dim an activation holds split is the one
    `collectives.mark` recorded; the batch dim is already this rank's
    rows).  It returns its input on a mesh whose "model" axis is of size 1,
    without `tp`, for the other tags (the residual stream stays whole on
    "model"; a MoE layer's dispatch is already laid out by its experts:
    under the context each rank builds its own experts' dispatch, or, where
    the experts do not divide over "model", the whole dispatch for its
    block of every expert's hidden units, `models/moe.py`) and for an
    activation whose layout no tensor-parallel code recorded.  `run` is
    the reference's argument: its `act_shard_embed` lays out only the
    residual stream."""
    from repro_torch.distributed.collectives import is_marked, model_split

    msize = mesh.shape.get("model", 1)

    def fn(x, tag, tp=None):
        if (msize == 1 or tp is None or tag != "qkv" or not is_marked(x)
                or x.ndim != 4):
            return x
        cur = model_split(x)
        shape = list(x.shape)
        if cur is not None:
            shape[cur] *= msize
        spec = activation_spec(mesh, tuple(shape), tag)
        target = 2 if spec[2] == "model" else None
        if cur == target:
            return x
        if cur is not None:
            x = tp.gather_from_model(x, cur)
        return x if target is None else tp.scatter_to_model(x, target)

    return fn
