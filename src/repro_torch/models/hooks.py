"""Activation-sharding hook.

Port of `repro/models/hooks.py`.  A launcher installs a constraint function;
the model calls `constrain(x, tag)` on the residual stream between layer
groups (and on q/k/v and the MoE dispatch).  Without a constraint it is the
identity, which is all serving on one card needs; item 26b's sharding rules
set one.
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
