"""int8 gradient compression with error feedback.

Port of `repro/optim/compress.py`.  Applied at the microbatch-accumulation
boundary (`models/train.py`): each microbatch gradient is quantized to int8
with a per-tensor scale before entering the accumulator; the quantization
residual is carried into the next microbatch (error feedback), so the
accumulated bias vanishes over the accumulation window.  Rounding is half to
even, as `jnp.round`'s; the scale is ``max|x| / 127 + 1e-30`` in float32.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import flatten, leaves


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grad: Any, err: Any) -> tuple[Any, Any]:
    """Returns (dequantized grads to accumulate, new error feedback)."""

    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize(g32)
        deq = dequantize(q, s)
        return deq, g32 - deq

    flat_g, rebuild, _ = flatten(grad)
    outs = [one(g, e) for g, e in zip(flat_g, leaves(err))]
    return (rebuild([o[0] for o in outs]), rebuild([o[1] for o in outs]))


def init_feedback(params: Any) -> Any:
    flat, rebuild, _ = flatten(params)
    return rebuild([torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in flat])
