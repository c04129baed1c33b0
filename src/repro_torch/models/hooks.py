"""Activation-sharding hook.

Port of `repro/models/hooks.py`.  A launcher installs a constraint function;
the model calls `constrain(x, tag)` on the residual stream between layer
groups (and on q/k/v and the MoE dispatch).  Without a constraint it is the
identity.  `launch/train.py` installs
`distributed.sharding.make_activation_constraint`, which computes the
reference's specs and returns `x` unchanged (as JAX's
`with_sharding_constraint` changes no value); tests install one that
injects JAX's MoE routing.
"""
from __future__ import annotations

from typing import Callable

_ACT_CONSTRAINT: Callable | None = None


def set_activation_constraint(fn: Callable | None):
    global _ACT_CONSTRAINT
    _ACT_CONSTRAINT = fn


def constrain(x, tag: str):
    if _ACT_CONSTRAINT is None:
        return x
    return _ACT_CONSTRAINT(x, tag)
