"""int8 gradient compression with error feedback.

Port of `repro/optim/compress.py`.  Applied at the microbatch-accumulation
boundary (`models/train.py`): each microbatch gradient is quantized to int8
with a per-tensor scale before entering the accumulator; the quantization
residual is carried into the next microbatch (error feedback), so the
accumulated bias vanishes over the accumulation window.  Rounding is half to
even, as `jnp.round`'s; the scale is ``max|x| / 127 + 1e-30`` in float32.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import flatten, leaves


def quantize(x: torch.Tensor, amax: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 values and the float32 scale of `x`; `amax` is max |x| (of the
    whole leaf where `x` is a block of it), computed here by default."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = amax / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grad: Any, err: Any,
                           reduce_max: Callable | None = None
                           ) -> tuple[Any, Any]:
    """Returns (dequantized grads to accumulate, new error feedback).
    `reduce_max` takes the leaves' largest |g + e| (a float32 vector, one a
    leaf) and returns each whole leaf's, where `grad` holds blocks (the
    sharded step: the maxima over the ranks); the scales are then the whole
    leaves' and a block quantizes as its whole leaf does."""
    flat_g, rebuild, _ = flatten(grad)
    g32 = [g.to(torch.float32) + e for g, e in zip(flat_g, leaves(err))]
    amax = torch.stack([torch.max(torch.abs(x)) for x in g32])
    if reduce_max is not None:
        amax = reduce_max(amax)
    outs = []
    for i, x in enumerate(g32):
        deq = dequantize(*quantize(x, amax[i]))
        outs.append((deq, x - deq))
    return (rebuild([o[0] for o in outs]), rebuild([o[1] for o in outs]))


def init_feedback(params: Any) -> Any:
    flat, rebuild, _ = flatten(params)
    return rebuild([torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in flat])
