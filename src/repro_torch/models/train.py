"""Serve-step factories.

Port of the serving half of `repro/models/train.py`: `make_prefill` and
`make_decode_step`.  The training half (`init_train_state`,
`make_train_step`, `params_specs`, `train_state_specs`) is ROADMAP item
26b.
"""
from __future__ import annotations

from .model import Model


def make_prefill(model: Model):
    def prefill(params, batch):
        return model.prefill(params, batch)
    return prefill


def make_decode_step(model: Model):
    def decode_step(params, caches, tokens):
        return model.decode_step(params, caches, tokens)
    return decode_step
