"""Pytrees of tensors in `jax.tree_util`'s order.

One flattener for every part of the port that walks a tree in the
reference's leaf order: the checkpointer (its ``arr_<i>.npy`` numbering
and treedef string), the optimizer (`optim/adamw.py`: the global norm sums
the leaves' squares in this order, so the clip scale and every update keep
the reference's bits) and the sharding rules (`distributed/sharding.py`).

A pytree here is what `jax.tree_util` flattens by default: dicts (keys in
sorted order), lists and tuples (named tuples too) are nodes, None has no
leaves, and everything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any) -> tuple[list, Callable[[list], Any], str]:
    """(leaves, rebuild, treedef) of `tree`, in `jax.tree_util`'s order;
    `rebuild(new_leaves)` makes the same structure around new leaves and
    `treedef` is the structure as the reference's checkpoint manifest
    writes it."""
    if tree is None:
        return [], lambda leaves: None, "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        spec = "{" + ", ".join(f"{k!r}: {p[2]}"
                               for k, p in zip(keys, parts)) + "}"
        return (*_join(parts, lambda vals: dict(zip(keys, vals))), spec)
    if isinstance(tree, (list, tuple)):
        parts = [flatten(v) for v in tree]
        inner = ", ".join(p[2] for p in parts)
        if _is_namedtuple(tree):
            cls = type(tree)
            return (*_join(parts, lambda vals: cls(*vals)),
                    f"CustomNode(namedtuple[{cls.__name__}], [{inner}])")
        if isinstance(tree, list):
            return (*_join(parts, list), f"[{inner}]")
        return (*_join(parts, tuple),
                f"({inner}{',' if len(parts) == 1 else ''})")
    return [tree], lambda leaves: leaves[0], "*"


def _join(parts, make):
    leaves = [leaf for p in parts for leaf in p[0]]
    sizes = [len(p[0]) for p in parts]

    def rebuild(new):
        out, off = [], 0
        for (_, sub, _), size in zip(parts, sizes):
            out.append(sub(new[off:off + size]))
            off += size
        return make(out)

    return leaves, rebuild


def leaves(tree: Any) -> list:
    """`jax.tree.leaves`: the leaves in flattening order."""
    return flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`jax.tree.map`: `fn` over the leaves of `tree` and of each tree in
    `rest`, which must have `tree`'s structure (compared by leaf count)."""
    flat, rebuild, _ = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError(f"tree_map: trees of {len(flat)} and "
                         f"{[len(o) for o in others]} leaves")
    return rebuild([fn(*args) for args in zip(flat, *others)])
