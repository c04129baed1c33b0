"""Mixture-of-experts layer (llama4-maverick top-1 + shared expert;
grok-1 top-2) in the capacity-bucketed formulation.

Port of `repro/models/moe.py`: tokens are dispatched to (expert,
capacity-slot) buckets with a one-hot einsum, expert FFNs run batched over
the expert dim, and results are combined with the gate weights.  Capacity
C = ceil(S * top_k * capacity_factor / E) keeps the FLOPs at the *active*
compute (plus the capacity slack) rather than E x dense.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import _dense_init, _one_hot, pdt


def init_moe(key, cfg: ModelConfig):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = pdt(cfg)
    p = {
        "router": _dense_init(key, (D, E), dt),
        "wi_gate": _dense_init(key, (E, D, Fd), dt, in_axis=1),
        "wi_up": _dense_init(key, (E, D, Fd), dt, in_axis=1),
        "wo": _dense_init(key, (E, Fd, D), dt, in_axis=1),
    }
    a = {
        "router": ("embed", "experts_r"),
        "wi_gate": ("experts", "embed", "mlp"),
        "wi_up": ("experts", "embed", "mlp"),
        "wo": ("experts", "mlp", "embed"),
    }
    if cfg.moe_shared_expert:
        p["shared"] = {
            "wi_gate": _dense_init(key, (D, Fd), dt),
            "wi_up": _dense_init(key, (D, Fd), dt),
            "wo": _dense_init(key, (Fd, D), dt),
        }
        a["shared"] = {"wi_gate": ("embed", "mlp"),
                       "wi_up": ("embed", "mlp"),
                       "wo": ("mlp", "embed")}
    return p, a


def _capacity(seq_len: int, cfg: ModelConfig) -> int:
    """Per-sequence-row expert capacity:
    C = ceil(int(S * top_k * capacity_factor) / E), rounded up to 4."""
    c = -(-int(seq_len * cfg.experts_per_token * cfg.capacity_factor)
          // cfg.num_experts)
    if c >= 4:
        c = -(-c // 4) * 4
    return max(1, c)


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, ties broken
    toward the lower index (a stable descending sort; `torch.topk`
    promises no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, cfg: ModelConfig, x, *, fp32_router: bool = True,
            shard_dispatch: bool = True, decode_pool: bool = True):
    """x (B, S, D) -> (B, S, D).  Dense capacity-bucketed dispatch."""
    B, S, D = x.shape
    if S == 1 and B > 1 and decode_pool:
        # decode: pool the whole batch into one routing row — otherwise the
        # per-row capacity floor pads every expert to >= 1 slot PER SEQUENCE
        y = moe_ffn(p, cfg, x.reshape(1, B, D), fp32_router=fp32_router,
                    shard_dispatch=shard_dispatch, decode_pool=False)
        return y.reshape(B, 1, D)
    E, K = cfg.num_experts, cfg.experts_per_token

    rdt = torch.float32 if fp32_router else x.dtype
    logits = x.to(rdt) @ p["router"].to(rdt)                 # (B,S,E)
    gates_all = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates_all, K)                        # (B,S,K)
    topv = topv / topv.sum(dim=-1, keepdim=True)

    C = _capacity(S, cfg)
    oh = _one_hot(topi, E, torch.int32)                      # (B,S,K,E)
    flat = oh.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(B, S, K, E)
    keep = (pos >= 0) & (pos < C)
    # dropped (token,k) pairs map to the overflow slot C, removed by the
    # [..., :C] slice — overflow handling is exact
    pos_oh = _one_hot(torch.where(keep, pos, C), C + 1,
                      x.dtype)[..., :C]                      # (B,S,K,E,C)
    from . import hooks
    ohx = oh.to(x.dtype)
    dispatch = torch.einsum("bske,bskec->bsec", ohx, pos_oh)
    combine = torch.einsum("bsk,bske,bskec->bsec", topv.to(x.dtype), ohx,
                           pos_oh)
    if shard_dispatch:
        dispatch = hooks.constrain(dispatch, "moe_dispatch")
        combine = hooks.constrain(combine, "moe_dispatch")

    xe = torch.einsum("bsec,bsd->ebcd", dispatch, x)         # (E,B,C,D)
    if shard_dispatch:
        xe = hooks.constrain(xe, "moe_expert")
    g = F.silu(torch.einsum("ebcd,edf->ebcf", xe,
                            p["wi_gate"].to(x.dtype)))
    u = torch.einsum("ebcd,edf->ebcf", xe, p["wi_up"].to(x.dtype))
    ye = torch.einsum("ebcf,efd->ebcd", g * u, p["wo"].to(x.dtype))
    if shard_dispatch:
        ye = hooks.constrain(ye, "moe_expert")
    y = torch.einsum("bsec,ebcd->bsd", combine, ye)          # (B,S,D)

    if cfg.moe_shared_expert:
        sp = p["shared"]
        gs = F.silu(x @ sp["wi_gate"].to(x.dtype))
        us = x @ sp["wi_up"].to(x.dtype)
        y = y + (gs * us) @ sp["wo"].to(x.dtype)
    return y


def aux_load_balance_loss(p, cfg: ModelConfig, x):
    """Switch-style load-balancing auxiliary loss (mean over tokens)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D).float()
    probs = torch.softmax(xt @ p["router"].float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = _one_hot(top1, cfg.num_experts, torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)
