"""Mixture-of-experts layer (llama4-maverick top-1 + shared expert;
grok-1 top-2) in the capacity-bucketed formulation.

Port of `repro/models/moe.py`: tokens are dispatched to (expert,
capacity-slot) buckets with a one-hot einsum, expert FFNs run batched over
the expert dim, and results are combined with the gate weights.  Capacity
C = ceil(S * top_k * capacity_factor / E) keeps the FLOPs at the *active*
compute (plus the capacity slack) rather than E x dense.

On a mesh (the sharded train and serving programs, `hooks`' tensor-parallel
context) the experts are "model" blocks, as the reference shards them:
the expert dim where the experts divide over "model" (expert
parallelism), else every expert's hidden units; each rank computes its
blocks' part of the layer and one all-reduce over "model" sums them
(`_moe`).  A decode step whose rows the FSDP axes split routes the global
batch's pool (`moe_ffn`'s `pool`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather

from . import hooks
from .layers import _dense_init, _one_hot, _whole_on_model, pdt


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
            shard_dispatch: bool = True, decode_pool: bool = True,
            pool=None):
    """x (B, S, D) -> (B, S, D).  Dense capacity-bucketed dispatch.

    `pool` (a `distributed.collectives.Axis` of several ranks, or None):
    the ranks over which a decode step's rows are split (the FSDP axes,
    this rank's rows the `pool.index`-th block).  The pooled routing row
    is then the global batch's, as the reference's: its capacity is the
    global one and its slots come in the global token order; this rank
    keeps its rows'."""
    B, S, D = x.shape
    rows = B * (pool.size if pool is not None else 1)
    if S == 1 and rows > 1 and decode_pool:
        # decode: pool the whole batch into one routing row — otherwise the
        # per-row capacity floor pads every expert to >= 1 slot PER SEQUENCE
        y = _moe(p, cfg, x.reshape(1, B, D), fp32_router, shard_dispatch,
                 pool)
        return y.reshape(B, 1, D)
    return _moe(p, cfg, x, fp32_router, shard_dispatch, None)


def _moe(p, cfg: ModelConfig, x, fp32_router: bool, shard_dispatch: bool,
         pool):
    """`moe_ffn` on routing rows `x` (B, S, D); `pool`: the ranks whose
    `x` (1, S, D) are the blocks of one pooled row, or None.

    Under the tensor-parallel context the experts are "model" blocks
    (`hooks.model_split` of wi_gate): this rank's experts (dim 0: expert
    parallelism) or every expert's block of hidden units (dim 2, where the
    experts do not divide over "model").  The layer is then one
    row-parallel layer: `x` enters through `copy_to_model`, the router is
    gathered whole (`gather`: each rank's router gradient covers only its
    experts' terms, so the backward sums them; a router whole on "model"
    is summed there by `copy_to`), every rank routes from the same bits,
    builds the dispatch and combine of its own experts (the capacity
    cumsum runs down each expert's column, so a block of columns has the
    whole's positions) and its partial output, and one `reduce_from_model`
    sums it, with the shared expert's partial sum on its "mlp" blocks."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    tp = hooks.tensor_parallel()
    split = hooks.model_split(p["wi_gate"])    # 0 experts, 2 hidden, None
    shared = p["shared"] if cfg.moe_shared_expert else None
    shared_split = (shared is not None
                    and hooks.model_split(shared["wi_gate"]) is not None)
    xin = (tp.copy_to_model(x) if split is not None or shared_split
           else x)
    xe_in = xin if split is not None else x

    rdt = torch.float32 if fp32_router else x.dtype
    router = _whole_on_model(p["router"], split is not None)
    logits = xe_in.to(rdt) @ router.to(rdt)                  # (B,S,E)
    gates_all = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(gates_all, K)                        # (B,S,K)
    topv = topv / topv.sum(dim=-1, keepdim=True)

    # a pool routes its ranks' rows in their order: the global capacity
    # and positions, of which this rank keeps its rows'
    n = 1 if pool is None else pool.size
    C = _capacity(S * n, cfg)
    oh = _one_hot(topi if pool is None else all_gather(topi, 1, pool), E,
                  torch.int32)                               # (B,nS,K,E)
    flat = oh.reshape(B, n * S * K, E)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(B, n * S, K, E)
    if pool is not None:
        oh = oh.narrow(1, pool.index * S, S)
        pos = pos.narrow(1, pool.index * S, S)
    if split == 0:                        # this rank's experts' columns
        el = p["wi_gate"].shape[0]
        oh = oh.narrow(-1, tp.model.index * el, el)
        pos = pos.narrow(-1, tp.model.index * el, el)
    dispatch, combine = _dispatch_combine(topv, oh, pos, C, x.dtype)
    if shard_dispatch:
        dispatch = hooks.constrain(dispatch, "moe_dispatch")
        combine = hooks.constrain(combine, "moe_dispatch")

    xe = torch.einsum("bsec,bsd->ebcd", dispatch, xe_in)     # (E,B,C,D)
    if shard_dispatch:
        xe = hooks.constrain(xe, "moe_expert")
    g = F.silu(torch.einsum("ebcd,edf->ebcf", xe,
                            p["wi_gate"].to(x.dtype)))
    u = torch.einsum("ebcd,edf->ebcf", xe, p["wi_up"].to(x.dtype))
    ye = torch.einsum("ebcf,efd->ebcd", g * u, p["wo"].to(x.dtype))
    if shard_dispatch:
        ye = hooks.constrain(ye, "moe_expert")
    y = torch.einsum("bsec,ebcd->bsd", combine, ye)          # (B,S,D)

    ys = None
    if shared is not None:
        sx = xin if shared_split else x
        gs = F.silu(sx @ shared["wi_gate"].to(x.dtype))
        us = sx @ shared["wi_up"].to(x.dtype)
        ys = (gs * us) @ shared["wo"].to(x.dtype)
        if shared_split == (split is not None):    # one sum for both
            y, ys = y + ys, None
    if split is not None:
        y = tp.reduce_from_model(y)
    if ys is not None:
        y = y + (tp.reduce_from_model(ys) if shared_split else ys)
    return y


def _dispatch_combine(topv, oh, pos, C: int, dtype):
    """The dispatch and combine (B,S,E,C) in `dtype` from the gates topv
    (B,S,K), the choices' one-hot oh (B,S,K,E) and their positions pos
    (B,S,K,E): the reference's einsums over the (B,S,K,E,C) one-hot of
    the kept positions, without it.  A token's k choices are distinct
    experts, so a (token, expert) pair has one slot at most: its kept
    position, else C (a dropped pair, or none), whose one-hot row is all
    zeros — overflow handling is exact.  The reference's sums over k add
    that one term to zeros: these are their values, bit for bit."""
    keep = (pos >= 0) & (pos < C)
    slot = torch.where(keep, pos, C).amin(dim=2)             # (B,S,E)
    dispatch = _one_hot(slot, C, dtype)
    gate = (topv.to(dtype)[..., None] * oh.to(dtype)).sum(dim=2)
    return dispatch, dispatch * gate[..., None]


def aux_load_balance_loss(p, cfg: ModelConfig, x):
    """Switch-style load-balancing auxiliary loss (mean over tokens)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D).float()
    probs = torch.softmax(xt @ p["router"].float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = _one_hot(top1, cfg.num_experts, torch.float32).mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)
