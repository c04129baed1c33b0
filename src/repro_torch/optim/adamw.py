"""AdamW with global-norm clipping, a warm-up and cosine schedule, and
moments in a chosen dtype.

Port of `repro/optim/adamw.py`.  The state mirrors the params tree (m and v
leaf for leaf, and an int32 `count`), so the sharding rules that place a
parameter place its moments (`distributed.sharding.opt_state_shardings`).

The reference's bits, in eager PyTorch:

  * leaves are walked in `jax.tree.leaves` order (`repro_torch.tree`), so
    the global norm sums the per-leaf squares in the reference's order;
  * every scalar (the step count, warm-up and cosine, the bias corrections
    ``b1 ** count``, the clip scale) is a float32 tensor on the params'
    device, as JAX computes them, never a Python float (f64, and a host
    read); a Python constant enters an operation as a float32, as JAX's
    weakly typed constants do, and ``c / x`` is a true division (PyTorch's
    ``float / tensor`` multiplies by a reciprocal);
  * each leaf's update is the reference's sequence of float32 roundings:
    products and sums one at a time (no fused multiply-add).

`update(..., donate=True)` writes the new params and moments into the
state's own tensors and uses the gradients as scratch, where the reference's
jitted step donates its state (`launch/train.py`): at full width a second
copy of params, m and v would not fit.  A moment whose dtype the update
changes gets a new tensor: `init_train_state` makes the moments in
`RunConfig.moment_dtype` and `update` returns them in
`AdamWConfig.moment_dtype`, so bfloat16 moments under the default config
come back float32 after the first step, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import flatten, leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moment dtype: bfloat16 cuts optimizer state 2x (8 -> 4 bytes/param);
    # moments are de/re-quantized around the fp32 update
    moment_dtype: str = "float32"


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (a float32 tensor on
    `step`'s device)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any, moment_dtype: str = "float32") -> dict:
    """Zero moments in `moment_dtype` beside each leaf, and an int32 count
    on the params' device."""
    dt = getattr(torch, moment_dtype)
    flat, rebuild, _ = flatten(params)

    def zeros():
        return rebuild([torch.zeros(p.shape, dtype=dt, device=p.device)
                        for p in flat])

    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=flat[0].device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the reference's order, of each
    leaf's float32 sum of squares."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


def _scratch(x: torch.Tensor, donate: bool) -> torch.Tensor:
    """`x` as float32 that the update may overwrite: `x` itself when it is
    donated and already float32, else a new tensor."""
    if x.dtype != torch.float32:
        return x.float()
    return x if donate else x.clone()


def _store(new32: torch.Tensor, old: torch.Tensor, dtype: torch.dtype,
           donate: bool) -> torch.Tensor:
    """The updated float32 leaf in `dtype`: written into `old` where it is
    donated and of that dtype, else a new tensor."""
    if new32.dtype == dtype:
        return new32
    if donate and old.dtype == dtype:
        return old.copy_(new32)
    return new32.to(dtype)


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, opt_state: dict, params: Any, *,
           donate: bool = False, gnorm: torch.Tensor | None = None):
    """Returns (new_params, new_opt_state, metrics).  With `donate`, the
    params' and moments' tensors are updated in place (the returned trees
    hold them) and `grads` is overwritten.  `gnorm` is the global norm of
    the whole gradient where `grads` holds only this rank's blocks of it
    (the data-parallel step); by default `global_norm(grads)`."""
    count = opt_state["count"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(_const(cfg.grad_clip, gnorm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, count)

    b1, b2 = cfg.b1, cfg.b2
    one = _const(1.0, gnorm)
    count32 = count.to(torch.float32)
    c1 = one / (1.0 - torch.pow(_const(b1, gnorm), count32))
    c2 = one / (1.0 - torch.pow(_const(b2, gnorm), count32))
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g = _scratch(g, donate).mul_(scale)
        m32 = _scratch(m, donate).mul_(b1).add_(g * (1 - b1))
        v32 = _scratch(v, donate).mul_(b2).add_((g * (1 - b2)).mul_(g))
        del g
        step = (m32 * c1).div_(torch.sqrt(v32 * c2).add_(cfg.eps))
        step.add_(cfg.weight_decay * p.float())
        p32 = _scratch(p, donate).sub_(step.mul_(lr))
        del step
        return (_store(p32, p, p.dtype, donate), _store(m32, m, mdt, donate),
                _store(v32, v, mdt, donate))

    flat_p, rebuild, _ = flatten(params)
    flat_g = leaves(grads)
    flat_m = leaves(opt_state["m"])
    flat_v = leaves(opt_state["v"])
    out = [upd(p, g, m, v)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = rebuild([o[0] for o in out])
    new_m = rebuild([o[1] for o in out])
    new_v = rebuild([o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "count": count}, metrics
