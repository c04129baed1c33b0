"""Model assembly for every assigned architecture family.

Port of `repro/models/model.py`.  A model is a PATTERN of block slots
repeated n_groups times over stacked parameters:

  dense/audio:   ["attn"]                      x L
  moe (grok):    ["moe"]                       x L
  moe (llama4):  ["attn", "moe"]               x L/2   (interleaved)
  vlm:           ["cross", "attn" x 4]         x L/5   (cross every 5th)
  ssm (rwkv6):   ["rwkv"]                      x L
  hybrid:        [shared-attn] + ["mamba" x 6] x L/6   (zamba2: the attn
                 block params are SHARED across groups)

Entry points (built by `build_model`):
  train_loss(params, batch)                 -> scalar loss (forward only)
  prefill(params, batch, max_len)           -> (logits_last, caches)
  decode_step(params, caches, tokens)       -> (logits, caches)

The contract is the reference's: params and caches are nested dicts and
lists of tensors with the reference's keys, every per-slot leaf stacked
with a leading "layers" axis of n_groups, and `init_params` returns
(params, axes).  The group loop is a Python loop that indexes the stacked
tensors (`t[g]`, views, no copy).  `RunConfig.scan_layers` and `remat`
change nothing here: the reference's `lax.scan` and `jax.checkpoint` only
shape its compiled program and its backward pass, and these entry points
run eagerly and forward only.  Every call is functional: a decode step
returns new caches and leaves its inputs unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig

from . import hooks, ssm
from .layers import (
    KV_CACHE_AXES, _gqa_scores_to_out, _proj, attention, cdt,
    decode_attention, embed_tokens, embed_tokens_onehot, init_attention,
    init_embedding, init_kv_cache, init_lm_head, init_mlp, init_rmsnorm,
    lm_logits, mlp, rmsnorm,
)
from .moe import aux_load_balance_loss, init_moe, moe_ffn


def _map(fn: Callable, *trees):
    """Map over the tensor leaves of nested dicts and lists (None stays
    None), the reference's `jax.tree.map` over params and caches."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [_map(fn, *xs) for xs in zip(*trees)]
    if t is None:
        return None
    return fn(*trees)


def _prepend_layers(axes):
    """Prepend the "layers" logical axis to every tuple leaf of an axes
    tree."""
    if isinstance(axes, dict):
        return {k: _prepend_layers(v) for k, v in axes.items()}
    return ("layers",) + tuple(axes)


def _stack(trees: list):
    return _map(lambda *a: torch.stack(a), *trees)


# -- pattern construction ------------------------------------------------------

def block_pattern(cfg: ModelConfig) -> tuple[list[str], int]:
    """Returns (slot types within one group, n_groups)."""
    L = cfg.num_layers
    if cfg.family in ("dense", "audio"):
        return ["attn"], L
    if cfg.family == "moe":
        if cfg.moe_every == 1:
            return ["moe"], L
        assert L % cfg.moe_every == 0
        return ["attn"] * (cfg.moe_every - 1) + ["moe"], L // cfg.moe_every
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        assert L % k == 0
        return ["cross"] + ["attn"] * (k - 1), L // k
    if cfg.family == "ssm":
        return ["rwkv"], L
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        assert L % k == 0
        return ["mamba"] * k, L // k   # + one SHARED attn block per group
    raise ValueError(cfg.family)


# -- per-slot init/apply -------------------------------------------------------

def _init_slot(key, cfg: ModelConfig, slot: str):
    p, a = {}, {}
    if slot in ("attn", "moe", "cross"):
        p["ln1"], a["ln1"] = init_rmsnorm(key, cfg)
        p["attn"], a["attn"] = init_attention(key, cfg)
        p["ln2"], a["ln2"] = init_rmsnorm(key, cfg)
        if slot == "moe":
            p["ffn"], a["ffn"] = init_moe(key, cfg)
        else:
            p["ffn"], a["ffn"] = init_mlp(key, cfg)
    elif slot == "rwkv":
        p["ln1"], a["ln1"] = init_rmsnorm(key, cfg)
        p["tm"], a["tm"] = ssm.init_rwkv6_time_mix(key, cfg)
        p["ln2"], a["ln2"] = init_rmsnorm(key, cfg)
        p["cm"], a["cm"] = ssm.init_rwkv6_channel_mix(key, cfg)
    elif slot == "mamba":
        p["ln1"], a["ln1"] = init_rmsnorm(key, cfg)
        p["mixer"], a["mixer"] = ssm.init_mamba2(key, cfg)
    else:
        raise ValueError(slot)
    return p, a


def _stack_init(init_fn: Callable, key, n: int):
    """n draws of a slot's params stacked on a leading 'layers' axis.  Each
    group is drawn and copied into the stacked tensors in turn, so the peak
    is the stack plus one group (not two stacks, as drawing all and
    stacking would hold)."""
    first, axes = init_fn(key)
    params = _map(lambda t: t.new_empty((n,) + t.shape), first)
    for g in range(n):
        p = first if g == 0 else init_fn(key)[0]
        _map(lambda dst, src: dst[g].copy_(src), params, p)
    return params, _prepend_layers(axes)


# -- block application (shared by train/prefill and decode) --------------------

def _apply_block(slot: str, p, cfg: ModelConfig, x, *, positions,
                 vision_embeds=None, cache=None, mode: str,
                 run: RunConfig, window: int = 0):
    """Returns (x, new_cache_or_kv)."""
    if slot in ("attn", "moe", "cross"):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        if mode == "decode":
            if slot == "cross":
                # cross KV is static after prefill: attend to cached K/V
                y, _ = _cross_decode(p["attn"], cfg, h, cache)
                new_cache = cache
            else:
                y, new_cache = decode_attention(p["attn"], cfg, h, cache,
                                                window=window)
        else:
            if slot == "cross":
                y, kv = attention(p["attn"], cfg, h, positions=positions,
                                  kv_src=vision_embeds)
            else:
                y, kv = attention(p["attn"], cfg, h, positions=positions,
                                  window=window, q_chunk=run.attn_q_chunk)
            new_cache = kv
        x = x + y
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if slot == "moe":
            y = moe_ffn(p["ffn"], cfg, h, fp32_router=run.use_fp32_router,
                        shard_dispatch=run.moe_shard_dispatch,
                        decode_pool=run.moe_decode_pool)
        else:
            y = mlp(p["ffn"], cfg, h)
        return x + y, new_cache
    if slot == "rwkv":
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        y, tm_new = ssm.rwkv6_time_mix(p["tm"], cfg, h, cache["tm"])
        x = x + y
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        y, cm_new = ssm.rwkv6_channel_mix(p["cm"], cfg, h, cache["cm"])
        return x + y, {"tm": tm_new, "cm": cm_new}
    if slot == "mamba":
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        y, st_new = ssm.mamba2(p["mixer"], cfg, h, cache)
        return x + y, st_new
    raise ValueError(slot)


def _cross_decode(p, cfg: ModelConfig, x, cache):
    """Single-token cross-attention against static (vision) K/V."""
    B, S1, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S1, H, hd)
    k, v = cache["k"], cache["v"]
    mask = torch.ones((1, 1, 1, S1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _gqa_scores_to_out(q, k, v, mask, cdt(cfg))
    return _proj(out.reshape(B, S1, H * hd), p["wo"]), None


# -- cache init ---------------------------------------------------------------

def _init_slot_cache(slot: str, cfg: ModelConfig, batch: int, max_len: int,
                     device):
    if slot in ("attn", "moe"):
        return init_kv_cache(cfg, batch, max_len, window=0, device=device)
    if slot == "cross":
        # static K/V over image tokens
        shape = (batch, cfg.n_image_tokens, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
    if slot == "rwkv":
        return ssm.init_rwkv6_state(cfg, batch, device=device)
    if slot == "mamba":
        return ssm.init_mamba2_state(cfg, batch, device=device)
    raise ValueError(slot)


def _slot_cache_axes(slot: str):
    if slot in ("attn", "moe"):
        return KV_CACHE_AXES
    if slot == "cross":
        return {"k": (None, None, "kv_heads", None),
                "v": (None, None, "kv_heads", None)}
    if slot == "rwkv":
        return ssm.RWKV6_STATE_AXES
    if slot == "mamba":
        return ssm.MAMBA2_STATE_AXES
    raise ValueError(slot)


# -- the model ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    run: RunConfig

    # ---- init ----
    def init_params(self, key: int | torch.Generator = 0, device=None):
        """(params, axes).  `key` is a seed or a `torch.Generator` (the
        reference's PRNG key): the draws run on the generator's device (a
        seed makes one on `device`) and the params land on `device`
        (default: the current CUDA device).  The draws cannot match
        `jax.random`'s; tests carry JAX's params over (`convert.py`)."""
        device = resolve_device(device)
        if not isinstance(key, torch.Generator):
            key = torch.Generator(device=device).manual_seed(int(key))
        cfg = self.cfg
        pattern, n_groups = block_pattern(cfg)
        params: dict[str, Any] = {}
        axes: dict[str, Any] = {}
        n_tables = max(cfg.n_codebooks, 1)
        params["embed"], axes["embed"] = init_embedding(
            key, cfg, n_tables=n_tables)
        params["final_ln"], axes["final_ln"] = init_rmsnorm(key, cfg)
        params["head"], axes["head"] = init_lm_head(key, cfg, n_tables)
        slots_p, slots_a = [], []
        for slot in pattern:
            p, a = _stack_init(lambda k, s=slot: _init_slot(k, cfg, s), key,
                               n_groups)
            slots_p.append(p)
            slots_a.append(a)
        params["slots"] = slots_p
        axes["slots"] = slots_a
        if cfg.family == "hybrid":
            p, a = _init_slot(key, cfg, "attn")   # ONE shared attn block
            params["shared_attn"] = p
            axes["shared_attn"] = a
        if key.device != device:
            params = _map(lambda t: t.to(device), params)
        return params, axes

    def init_caches(self, batch: int, max_len: int, mode: str = "decode",
                    device=None):
        """Zero caches stacked over the groups (broadcast views, as the
        reference's `broadcast_to`; nothing here writes into a cache)."""
        device = resolve_device(device)
        cfg = self.cfg
        pattern, n_groups = block_pattern(cfg)

        def stack(c):
            return _map(lambda x: x[None].expand((n_groups,) + x.shape), c)

        caches = [stack(_init_slot_cache(s, cfg, batch, max_len, device))
                  for s in pattern]
        out = {"slots": caches}
        if cfg.family == "hybrid":
            shared = _init_slot_cache(
                "attn", cfg, batch, min(max_len, cfg.attn_window or max_len),
                device)
            out["shared_attn"] = stack(shared)
        return out

    def cache_axes(self):
        pattern, _ = block_pattern(self.cfg)
        out = {"slots": [_prepend_layers(_slot_cache_axes(s))
                         for s in pattern]}
        if self.cfg.family == "hybrid":
            out["shared_attn"] = _prepend_layers(_slot_cache_axes("attn"))
        return out

    # ---- forward over the stack ----
    def _stack_forward(self, params, x, *, positions, vision_embeds,
                       caches, mode):
        """Loop over groups. Returns (x, new_caches); new_caches is None in
        train mode (per-layer KV and states are not stacked there)."""
        cfg, run = self.cfg, self.run
        pattern, n_groups = block_pattern(cfg)
        window = cfg.attn_window or 0
        shared_p = params.get("shared_attn")
        slot_caches = (caches["slots"] if caches is not None
                       else [None for _ in pattern])
        shared_caches = caches.get("shared_attn") if caches else None

        new_slots, new_shared = [], []
        for g in range(n_groups):
            def take(t):
                return _map(lambda a: a[g], t)
            x = hooks.constrain(x, "residual")
            sc = take(shared_caches)
            if cfg.family == "hybrid":
                x, sc = _apply_block(
                    "attn", shared_p, cfg, x, positions=positions,
                    cache=sc, mode=mode, run=run, window=window)
            group_caches = []
            for slot, p, c in zip(pattern, take(params["slots"]),
                                  take(slot_caches)):
                x, nc = _apply_block(
                    slot, p, cfg, x, positions=positions,
                    vision_embeds=vision_embeds, cache=c, mode=mode,
                    run=run)
                group_caches.append(nc)
            if mode != "train":
                new_slots.append(group_caches)
                new_shared.append(sc)
        if mode == "train":
            return x, None
        out_caches = {"slots": _stack(new_slots)}
        if new_shared[0] is not None:
            out_caches["shared_attn"] = _stack(new_shared)
        return x, out_caches

    # ---- entry points ----
    def forward(self, params, tokens, *, vision_embeds=None, caches=None,
                mode="train", positions=None):
        cfg = self.cfg
        if self.run.embed_onehot:
            x = embed_tokens_onehot(params["embed"], cfg, tokens)
        else:
            x = embed_tokens(params["embed"], cfg, tokens)
        x = hooks.constrain(x.to(cdt(cfg)), "residual")
        if positions is None:
            if mode == "decode":
                raise ValueError("decode needs caches with positions")
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        x, new_caches = self._stack_forward(
            params, x, positions=positions, vision_embeds=vision_embeds,
            caches=caches, mode=mode)
        x = rmsnorm(params["final_ln"], x, cfg.norm_eps)
        logits = lm_logits(params["head"], cfg, x)
        return logits, new_caches

    def train_loss(self, params, batch):
        """batch: {"tokens": (B, S+1[, n_cb]) int32, "vision_embeds"?}.
        Forward only here (the training step is item 26b)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        # fresh states for ssm/hybrid (train runs through the recurrence)
        caches = None
        if cfg.family in ("ssm", "hybrid"):
            caches = self.init_caches(inputs.shape[0], inputs.shape[1],
                                      mode="train", device=tokens.device)
        logits, _ = self.forward(
            params, inputs, vision_embeds=batch.get("vision_embeds"),
            caches=caches, mode="train")
        # CE as logsumexp(logits) - logits[label], no one-hot over the vocab
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.take_along_dim(
            logits, labels[..., None].long(), dim=-1)[..., 0]
        loss = torch.mean(lse - picked)
        if cfg.num_experts:
            loss = loss + 0.01 * self._moe_aux(params, batch)
        return loss

    def _moe_aux(self, params, batch):
        # the reference's surrogate: load-balance loss at the embedding
        # output of the first MoE slot's router (group 0)
        cfg = self.cfg
        tokens = batch["tokens"][:, :-1]
        x = embed_tokens(params["embed"], cfg, tokens).to(cdt(cfg))
        pattern, _ = block_pattern(cfg)
        i = pattern.index("moe")
        p0 = _map(lambda a: a[0], params["slots"][i])
        return aux_load_balance_loss(p0["ffn"], cfg, x)

    def prefill(self, params, batch, max_len: int | None = None):
        """Returns (last-token logits, decode-ready caches).  `max_len`
        reserves decode headroom in the KV caches (default: none)."""
        tokens = batch["tokens"]
        B, S = tokens.shape[0], tokens.shape[1]
        max_len = max_len or S
        caches = self.init_caches(B, max_len, mode="prefill",
                                  device=tokens.device)
        logits, kv = self.forward(
            params, tokens, vision_embeds=batch.get("vision_embeds"),
            caches=caches, mode="prefill")
        caches = self._kv_to_caches(kv, caches, S, max_len, tokens.device)
        return logits[:, -1:], caches

    def _kv_to_caches(self, kv, fresh, S, max_len, dev):
        pattern, n_groups = block_pattern(self.cfg)

        def pad_seq(x, target):
            if x.shape[2] >= target:
                return x
            return torch.nn.functional.pad(
                x, (0, 0) * (x.ndim - 3) + (0, target - x.shape[2]))

        def positions(n, size):
            """Slot positions 0..n-1, then -1 (empty) up to size."""
            return torch.cat([
                torch.arange(n, dtype=torch.int32, device=dev),
                torch.full((size - n,), -1, dtype=torch.int32, device=dev),
            ])[None].expand(n_groups, size)

        def pos_at_s():
            return torch.full((n_groups,), S, dtype=torch.int32, device=dev)

        out_slots = []
        for i, slot in enumerate(pattern):
            got = kv["slots"][i]
            base = fresh["slots"][i]
            if slot in ("attn", "moe"):
                out_slots.append({
                    "k": pad_seq(got["k"].to(base["k"].dtype), max_len),
                    "v": pad_seq(got["v"].to(base["v"].dtype), max_len),
                    "pos": pos_at_s(),
                    "slot_pos": positions(S, max_len),
                })
            elif slot == "cross":
                out_slots.append({"k": got["k"].to(base["k"].dtype),
                                  "v": got["v"].to(base["v"].dtype)})
            else:  # ssm states pass through
                out_slots.append(got)
        out = {"slots": out_slots}
        if "shared_attn" in fresh:
            got = kv["shared_attn"]
            W = fresh["shared_attn"]["k"].shape[2]  # ring size (window)
            if W < S:
                # keep the last W tokens, laid out to preserve the ring
                # invariant slot == position % W used by decode_attention
                p_list = torch.arange(S - W, S, dtype=torch.int32, device=dev)
                order = torch.argsort(p_list % W)
                k_ring = got["k"][:, :, -W:][:, :, order]
                v_ring = got["v"][:, :, -W:][:, :, order]
                slot_pos = p_list[order][None].expand(n_groups, W)
            else:
                k_ring = pad_seq(got["k"], W)
                v_ring = pad_seq(got["v"], W)
                slot_pos = positions(S, W)
            out["shared_attn"] = {
                "k": k_ring.to(torch.bfloat16),
                "v": v_ring.to(torch.bfloat16),
                "pos": pos_at_s(),
                "slot_pos": slot_pos,
            }
        return out

    def decode_step(self, params, caches, tokens):
        """tokens (B, 1[, n_cb]) -> (logits (B,1[,n_cb],V), new caches).
        The position comes from the caches; `positions` is a dummy."""
        return self.forward(
            params, tokens, caches=caches, mode="decode",
            positions=torch.zeros((1,), dtype=torch.int32,
                                  device=tokens.device))


def build_model(cfg: ModelConfig, run: RunConfig | None = None) -> Model:
    return Model(cfg=cfg, run=run or RunConfig())
