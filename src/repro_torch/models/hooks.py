"""Activation-sharding hook and the tensor-parallel context.

Port of `repro/models/hooks.py`.  A launcher installs a constraint function;
the model calls `constrain(x, tag)` on the residual stream between layer
groups (and on q/k/v and the MoE dispatch).  Without a constraint it is the
identity.  `launch/train.py` installs
`distributed.sharding.make_activation_constraint`, which re-lays q, k and v
over "model" to the reference's spec under the tensor-parallel context;
tests install one that injects JAX's MoE routing (off the mesh, where the
MoE dispatch is whole; under the context it is this rank's experts').

The port adds the tensor-parallel context: the sharded train step
(`models/train.py`) installs a `distributed.collectives.TensorParallel`
around its forward and backward (`tensor_parallel_scope`).  The model then
gathers each layer group's param blocks through it, and the layers ask
`model_split` which dim of a weight is split over "model" (column- or
row-parallel; an expert weight's expert dim or hidden units, `moe.py`).
Without a context (`tensor_parallel()` is None) the layers compute with
the whole params they are given, as before.

The port also adds a counting device for the dry run (`launch/dryrun.py`):
under `time_loop_limit(n)` the SSM time loops (`ssm.py`) run at most n of
their steps and stand empty tensors in for the rest, on `meta` tensors
only.  A step's ops are the same at every step of a loop, so the dry run
counts a few trip counts and fits the rest exactly.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.distributed.collectives import model_split  # noqa: F401

_ACT_CONSTRAINT: Callable | None = None
_TENSOR_PARALLEL = None
_TIME_LOOP_LIMIT: int | None = None


def set_activation_constraint(fn: Callable | None):
    global _ACT_CONSTRAINT
    _ACT_CONSTRAINT = fn


def constrain(x, tag: str):
    """`x` through the installed constraint; under the tensor-parallel
    context the constraint also gets the `TensorParallel` (`fn(x, tag,
    tp)`), else `fn(x, tag)`."""
    if _ACT_CONSTRAINT is None:
        return x
    if _TENSOR_PARALLEL is None:
        return _ACT_CONSTRAINT(x, tag)
    return _ACT_CONSTRAINT(x, tag, _TENSOR_PARALLEL)


def tensor_parallel():
    """The installed `TensorParallel`, or None."""
    return _TENSOR_PARALLEL


@contextlib.contextmanager
def tensor_parallel_scope(tp):
    """Install `tp` (a `distributed.collectives.TensorParallel`, or None)
    for the block; the previous context comes back after it."""
    global _TENSOR_PARALLEL
    prev, _TENSOR_PARALLEL = _TENSOR_PARALLEL, tp
    try:
        yield tp
    finally:
        _TENSOR_PARALLEL = prev


@contextlib.contextmanager
def time_loop_limit(n: int | None):
    """The SSM time loops inside the block run at most `n` steps (None: all
    of them), on `meta` tensors only (`time_steps`)."""
    global _TIME_LOOP_LIMIT
    if n is not None and n < 1:
        raise ValueError(f"a time loop runs at least one step, not {n}")
    prev, _TIME_LOOP_LIMIT = _TIME_LOOP_LIMIT, n
    try:
        yield
    finally:
        _TIME_LOOP_LIMIT = prev


def time_steps(S: int, device) -> int:
    """The steps an SSM time loop over S positions runs: S, or under
    `time_loop_limit(n)` min(S, n), which only a count on `meta` may ask
    for (the steps it skips compute nothing)."""
    if _TIME_LOOP_LIMIT is None or _TIME_LOOP_LIMIT >= S:
        return S
    if torch.device(device).type != "meta":
        raise ValueError("time_loop_limit cuts the SSM time loops short: a "
                         "dry-run count on meta tensors only")
    return _TIME_LOOP_LIMIT
