"""Carry state between `repro` (the JAX package) and the port.

The JAX package's state crosses as numpy arrays and plain dicts, so this
module imports nothing of JAX: the caller hands over `np.asarray(...)` of
the arrays and `dataclasses.asdict(spec)` of a `repro.api.EmbedSpec`.  With
these, both packages fit from identical affinities and starting points.
The artifact format (`api/artifact.py`) crosses the other way too: it
writes the port's `kernel_impl` in the reference's words
(`KERNEL_IMPL_TO_JAX`) and reads a `repro` spec through
`spec_from_jax_fields`.  The LM scaffolding's params and caches cross
through `lm_tree_from_numpy`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.spec import EmbedSpec
from repro_torch.core.affinities import Affinities
from repro_torch.core.linesearch import LSConfig
from repro_torch.sparse.graph import NeighborGraph, SparseAffinities

#: `repro` kernel_impl names -> the port's
KERNEL_IMPL = {"auto": "auto", "pallas": "kernel", "pallas-interpret": "torch",
               "jnp": "torch"}
#: the port's kernel_impl names -> `repro`'s (the artifact writer's)
KERNEL_IMPL_TO_JAX = {"auto": "auto", "kernel": "pallas", "torch": "jnp"}

#: `repro.api.EmbedSpec` fields of parts this port does not have yet, which
#: `spec_from_jax_fields` drops; empty since checkpointing is ported
UNPORTED_FIELDS = frozenset()


def affinities_from_numpy(Wp, Wm, device) -> Affinities:
    """`repro.core.Affinities` arrays -> float32 tensors on `device`."""
    return Affinities(*(torch.tensor(np.asarray(w), dtype=torch.float32,
                                     device=device) for w in (Wp, Wm)))


def saff_from_numpy(indices, weights, rev_indices, rev_weights,
                    device) -> SparseAffinities:
    """`repro.sparse.SparseAffinities` arrays (the graph's and, unless None,
    its reverse graph's) -> int32 / float32 tensors on `device`."""
    def graph(idx, w):
        return NeighborGraph(
            torch.tensor(np.asarray(idx), dtype=torch.int32, device=device),
            torch.tensor(np.asarray(w), dtype=torch.float32, device=device))

    rev = (graph(rev_indices, rev_weights) if rev_indices is not None
           else None)
    return SparseAffinities(graph=graph(indices, weights), rev=rev)


def embedding_from_numpy(X, device) -> torch.Tensor:
    """An (N, d) embedding (e.g. a JAX starting point) -> float32 tensor."""
    return torch.tensor(np.asarray(X), dtype=torch.float32, device=device)


def spec_from_jax_fields(fields: dict) -> EmbedSpec:
    """`dataclasses.asdict(repro.api.EmbedSpec(...))` -> the port's
    EmbedSpec.  `kernel_impl` maps pallas -> kernel and jnp /
    pallas-interpret -> torch; the line-search config maps field by field;
    `UNPORTED_FIELDS` are dropped; any other unknown field raises.
    """
    known = {f.name for f in dataclasses.fields(EmbedSpec)}
    out = {}
    for name, value in fields.items():
        if name in UNPORTED_FIELDS:
            continue
        if name not in known:
            raise ValueError(f"EmbedSpec field {name!r} has no counterpart "
                             f"in repro_torch")
        if name == "kernel_impl":
            value = KERNEL_IMPL[value]
        elif name == "ls" and value is not None:
            value = LSConfig(**(value._asdict() if hasattr(value, "_asdict")
                                else dict(value)))
        elif name == "strategy_opts":
            value = dict(value)
        out[name] = value
    return EmbedSpec(**out)


def lm_tree_from_numpy(tree, device):
    """The JAX package's LM params or caches as numpy
    (`jax.tree.map(np.asarray, ...)`: nested dicts and lists of arrays) ->
    the same tree of tensors on `device`, every dtype kept.  JAX's bfloat16
    reaches numpy as an extension dtype that `torch.tensor` does not take:
    it is recognised by name and carried as its bits (uint16 viewed as
    torch.bfloat16)."""
    if isinstance(tree, dict):
        return {k: lm_tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lm_tree_from_numpy(v, device) for v in tree]
    if tree is None:
        return None
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
