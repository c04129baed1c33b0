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
  train_loss(params, batch)                 -> scalar loss (autograd)
  prefill(params, batch, max_len)           -> (logits_last, caches)
  decode_step(params, caches, tokens)       -> (logits, caches)

The contract is the reference's: params and caches are nested dicts and
lists of tensors with the reference's keys, every per-slot leaf stacked
with a leading "layers" axis of n_groups, and `init_params` returns
(params, axes).  The group loop is a Python loop that indexes the stacked
tensors (`t[g]`, views, no copy).  `RunConfig.scan_layers` changes no
value: the reference's `lax.scan` only shapes its compiled program.
`RunConfig.remat == "full"` is the reference's `jax.checkpoint(...,
nothing_saveable)` around one group's body: in a differentiated train
forward each group runs under `torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)`, which keeps only the group's input and recomputes
the rest in the backward pass (the same values; the autograd graph of the
SSM time loops stays one group deep).  Every call is functional: a decode
step returns new caches and leaves its inputs unchanged.

Under the sharded train step's tensor-parallel context (`hooks`,
`models/train.py`) `params` holds this rank's blocks.  The group loop
selects group g's blocks from the stacked leaves (`params[g]` on blocks)
and gathers them over the FSDP axes inside the remat region, so that the
recompute gathers them again and the backward reduce-scatters their
gradients.  The layers compute on the "model" blocks: attention and the
vision cross-attention on this rank's heads, the MLPs on their hidden
units, the MoE layers on this rank's experts (or every expert's hidden
units where the experts do not divide over "model"), the SSM mixers on
this rank's heads (`ssm.py`), except where a slot's heads do not divide
over "model": that slot's mixer leaves are gathered over "model" too and
every rank computes every head, its states whole (`whole_subtrees`, the
one fallback).
The embedding, the final norm and the head are gathered where the forward
reads them, `_moe_aux`'s embedding and router where it reads them, and the
loss is vocab-parallel over the logits' vocab blocks.  The sharded prefill
and decode step (`models/train.py` `make_prefill`, `make_decode_step`)
run the same forward on this rank's rows of the batch and hold the caches
as blocks (`Model.cache_shardings`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.collectives import local_slice, mark, split_dims
from repro_torch.distributed.sharding import batch_rows, tree_shardings
from repro_torch.tree import tree_map

from . import hooks, ssm
from .layers import (
    KV_CACHE_AXES, _gqa_scores_to_out, _kv_for_heads, _MetaKey,
    _model_input, _proj, attention, cdt, decode_attention, embed_tokens,
    embed_tokens_onehot, init_attention, init_embedding, init_kv_cache,
    init_lm_head, init_mlp, init_rmsnorm, lm_logits, mlp, rmsnorm,
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


#: per SSM slot, the subtrees of its mixers (`ssm.py`)
_SSM_SUBTREES = {"rwkv": ("tm", "cm"), "mamba": ("mixer",)}
#: the SSM state leaves that stay whole on "model" on a mesh, their rows on
#: the FSDP axes (`Model.cache_shardings`): a step reads `x_prev` whole, and
#: a rank's conv channels are not a contiguous block of the spec's
_WHOLE_STATES = ("x_prev", "conv")


def whole_subtrees(cfg: ModelConfig, slot: str, m: int) -> tuple:
    """The subtrees of `slot` that a mesh whose "model" axis has m ranks
    gathers over "model" too, so that every rank computes them whole: an
    SSM slot's mixers where its heads do not divide over m (elsewhere a
    rank computes its heads); none for every other slot."""
    if slot not in _SSM_SUBTREES or ssm.n_heads(cfg, slot) % m == 0:
        return ()
    return _SSM_SUBTREES[slot]


def _gathered(params, shardings, slot: str | None = None,
              layers: bool = False, cfg: ModelConfig | None = None):
    """A slot's (or any) param subtree as this rank computes with it under
    the tensor-parallel context: `params` itself without one."""
    tp = hooks.tensor_parallel()
    if tp is None:
        return params
    whole = whole_subtrees(cfg, slot, tp.model.size) if slot else ()
    return {k: tp.gather_params(v, shardings[k], layers=layers,
                                whole=k in whole)
            for k, v in params.items()}


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
                 run: RunConfig, window: int = 0, moe_pool=None):
    """Returns (x, new_cache_or_kv).  `moe_pool`: `moe_ffn`'s `pool`."""
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
                        decode_pool=run.moe_decode_pool, pool=moe_pool)
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
        y, st_new = ssm.mamba2(p["mixer"], cfg, h, cache,
                               keep_state=mode != "train")
        return x + y, st_new
    raise ValueError(slot)


def _cross_decode(p, cfg: ModelConfig, x, cache):
    """Single-token cross-attention against static (vision) K/V.

    On "model" blocks q comes in `layers.attention`'s layout (this rank's
    heads where H divides over "model", else every head) and the cache is
    this rank's block, its layout marked on cache["k"]: 2, its kv heads
    ("kv_heads", whose q heads are this rank's), else every kv head; the
    output goes through the row-parallel wo."""
    B, S1, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k, v = cache["k"], cache["v"]
    q0 = None
    if hooks.model_split(p["wq"]) == 1:
        tp = hooks.tensor_parallel()
        m = tp.model.size
        q = _proj(_model_input(x, p["wq"]), p["wq"], p.get("bq"))
        if H % m:
            q = tp.gather_from_model(q, -1)
        q = mark(q.reshape(B, S1, -1, hd), None if H % m else 2)
        if (hooks.model_split(k) == 2) != (KV % m == 0):
            raise ValueError(f"a cross cache block of {k.shape[2]} kv heads "
                             f"on a {m}-way 'model' axis")
        if not H % m and KV % m:
            q0 = tp.model.index * (H // m)
    else:
        q = _proj(x, p["wq"], p.get("bq")).reshape(B, S1, H, hd)
    heads_local = hooks.model_split(q) is not None
    mask = torch.ones((1, 1, 1, S1, k.shape[1]), dtype=torch.bool,
                      device=x.device)
    kq, vq = (k, v) if q0 is None else _kv_for_heads(k, v, q0, q.shape[2],
                                                      H // KV)
    out = _gqa_scores_to_out(q, kq, vq, mask, cdt(cfg))
    out = out.reshape(B, S1, q.shape[2] * hd)
    if hooks.model_split(p["wo"]) == 0 and not heads_local:
        out = hooks.tensor_parallel().scatter_to_model(out, -1)
    return _proj(out, p["wo"]), None


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
        (default: the current CUDA device).  On `meta` nothing is drawn:
        empty tensors of the params' shapes and dtypes.  The draws cannot match
        `jax.random`'s; tests carry JAX's params over (`convert.py`)."""
        device = resolve_device(device)
        if device.type == "meta":
            key = _MetaKey()          # shapes only: no draw (params_specs)
        elif not isinstance(key, torch.Generator):
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
                    device=None, shardings=None):
        """Zero caches stacked over the groups (broadcast views, as the
        reference's `broadcast_to`; nothing here writes into a cache).
        With `shardings` (`cache_shardings` for the same batch and
        max_len), this rank's blocks of them (views)."""
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
        if shardings is not None:
            out = tree_map(lambda s, x: s.local_view(x), shardings, out)
        return out

    def cache_axes(self):
        pattern, _ = block_pattern(self.cfg)
        out = {"slots": [_prepend_layers(_slot_cache_axes(s))
                         for s in pattern]}
        if self.cfg.family == "hybrid":
            out["shared_attn"] = _prepend_layers(_slot_cache_axes("attn"))
        return out

    def cache_shardings(self, mesh, batch: int, max_len: int):
        """The caches' `NamedSharding` tree on `mesh` for `batch` rows and
        `max_len` slots (`init_caches`' shapes): the reference's rules over
        `cache_axes()` (a KV cache's rows on the FSDP axes and its heads
        on "model", else its slots: "kv_heads", then "kv_seq", each only
        where it divides; an SSM state's heads on "ssm_heads", where they
        divide), except that the SSM states' `x_prev` and `conv` are whole
        on "model", their rows on the FSDP axes (`_WHOLE_STATES`), and that
        the vision cross-attention's K/V put their rows on the FSDP axes
        (the reference keeps them whole; the cross-attention computes this
        rank's rows), their kv heads on "model" where they divide.  Only
        `mesh.axis_names` and `mesh.shape` are read."""
        pattern, _ = block_pattern(self.cfg)
        axes = self.cache_axes()
        axes["slots"] = [_rows_only(a, _WHOLE_STATES) if s in _SSM_SUBTREES
                         else _rows_on_batch(a) if s == "cross" else a
                         for s, a in zip(pattern, axes["slots"])]
        specs = self.init_caches(batch, max_len, device="meta")
        return tree_shardings(mesh, axes, specs)

    # ---- forward over the stack ----
    def _stack_forward(self, params, x, *, positions, vision_embeds,
                       caches, mode, cache_shardings=None, to_cache=None,
                       moe_pool=None):
        """Loop over groups. Returns (x, new_caches); new_caches is None in
        train mode (per-layer KV and states are not stacked there).
        `to_cache(key, kv)` turns a group's prefill output of slot `key`
        (its index, or "shared_attn") into its cache before the groups are
        stacked.  Under the tensor-parallel context a decode step's KV
        and cross cache blocks are marked with their "model" layout from
        `cache_shardings` (`layers.decode_attention` and `_cross_decode`
        read it).  `moe_pool`: `moe_ffn`'s `pool`."""
        cfg, run = self.cfg, self.run
        pattern, n_groups = block_pattern(cfg)
        window = cfg.attn_window or 0
        shared_p = params.get("shared_attn")
        slot_caches = (caches["slots"] if caches is not None
                       else [None for _ in pattern])
        shared_caches = caches.get("shared_attn") if caches else None
        tp = hooks.tensor_parallel()
        sh = tp.shardings if tp is not None else {
            "slots": [None] * len(pattern), "shared_attn": None}
        csh = cache_shardings if tp is not None and mode == "decode" \
            else None

        def marked(c, s):
            if csh is None or not isinstance(c, dict) or "v" not in c:
                return c
            for key in ("k", "v"):
                _, mdim = split_dims(s[key], c[key].ndim + 1, tp.fsdp_axes)
                mark(c[key], None if mdim is None else mdim - 1)
            return c

        def group(g, x):
            def take(t):
                return _map(lambda a: a[g], t)
            x = hooks.constrain(x, "residual")
            sc = marked(take(shared_caches), csh and csh.get("shared_attn"))
            if cfg.family == "hybrid":
                x, sc = _apply_block(
                    "attn", _gathered(shared_p, sh["shared_attn"]), cfg, x,
                    positions=positions, cache=sc, mode=mode, run=run,
                    window=window)
            group_caches = []
            slots = [_gathered(p, s, slot, layers=True, cfg=cfg)
                     for slot, p, s in zip(pattern, take(params["slots"]),
                                           sh["slots"])]
            slot_sh = csh["slots"] if csh else [None] * len(pattern)
            for slot, p, c, s in zip(pattern, slots, take(slot_caches),
                                     slot_sh):
                x, nc = _apply_block(
                    slot, p, cfg, x, positions=positions,
                    vision_embeds=vision_embeds, cache=marked(c, s),
                    mode=mode, run=run, moe_pool=moe_pool)
                group_caches.append(nc)
            return x, group_caches, sc

        remat = (mode == "train" and run.remat == "full"
                 and torch.is_grad_enabled())
        new_slots, new_shared = [], []
        for g in range(n_groups):
            if remat:
                # train mode keeps no per-layer KV or states, so the
                # group's output is all it returns; it draws nothing, so
                # there is no RNG state to stash
                x = checkpoint(lambda x, g=g: group(g, x)[0], x,
                               use_reentrant=False, preserve_rng_state=False)
                continue
            x, group_caches, sc = group(g, x)
            if mode != "train":
                if to_cache is not None:
                    group_caches = [to_cache(i, c)
                                    for i, c in enumerate(group_caches)]
                    if sc is not None:
                        sc = to_cache("shared_attn", sc)
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
                mode="train", positions=None, cache_shardings=None,
                to_cache=None, moe_pool=None):
        cfg = self.cfg
        embed = self._outer(params, ("embed",))["embed"]
        if self.run.embed_onehot:
            x = embed_tokens_onehot(embed, cfg, tokens)
        else:
            x = embed_tokens(embed, cfg, tokens)
        del embed
        x = hooks.constrain(x.to(cdt(cfg)), "residual")
        if positions is None:
            if mode == "decode":
                raise ValueError("decode needs caches with positions")
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        x, new_caches = self._stack_forward(
            params, x, positions=positions, vision_embeds=vision_embeds,
            caches=caches, mode=mode, cache_shardings=cache_shardings,
            to_cache=to_cache, moe_pool=moe_pool)
        outer = self._outer(params, ("final_ln", "head"))
        x = rmsnorm(outer["final_ln"], x, cfg.norm_eps)
        logits = lm_logits(outer["head"], cfg, x)
        return logits, new_caches

    @staticmethod
    def _outer(params, keys) -> dict:
        """The params outside the group loop, gathered under the
        tensor-parallel context."""
        tp = hooks.tensor_parallel()
        return {k: _gathered(params[k], tp.shardings[k] if tp else None)
                for k in keys}

    def train_loss(self, params, batch):
        """batch: {"tokens": (B, S+1[, n_cb]) int32, "vision_embeds"?}: the
        mean next-token cross-entropy, plus 0.01 of the MoE load-balance
        loss.  Differentiable by autograd for every family."""
        loss = self._token_loss(params, batch)
        if self.cfg.num_experts:
            loss = loss + 0.01 * self._moe_aux(params, batch)
        return loss

    def _token_loss(self, params, batch):
        """The cross-entropy part of `train_loss`: a mean over the batch's
        positions, so the mean over equal row blocks is the batch's (the
        data-parallel step, `models/train.py`, splits it so)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        # fresh states for ssm/hybrid (train runs through the recurrence)
        caches = None
        if cfg.family in ("ssm", "hybrid"):
            caches = self.init_caches(inputs.shape[0], inputs.shape[1],
                                      mode="train", device=tokens.device)
            tp = hooks.tensor_parallel()
            if tp is not None:          # a rank's heads' block of each
                pattern, _ = block_pattern(cfg)
                caches["slots"] = [
                    _own_heads(c, tp.model)
                    if s in _SSM_SUBTREES and not whole_subtrees(
                        cfg, s, tp.model.size) else c
                    for s, c in zip(pattern, caches["slots"])]
        logits, _ = self.forward(
            params, inputs, vision_embeds=batch.get("vision_embeds"),
            caches=caches, mode="train")
        # CE as logsumexp(logits) - logits[label], no one-hot over the vocab
        split = hooks.model_split(logits) is not None
        logits = logits.float()
        if split:
            return _vocab_parallel_ce(logits, labels)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.take_along_dim(
            logits, labels[..., None].long(), dim=-1)[..., 0]
        return torch.mean(lse - picked)

    def _moe_aux(self, params, batch):
        # the reference's surrogate: load-balance loss at the embedding
        # output of the first MoE slot's router (group 0)
        cfg = self.cfg
        tokens = batch["tokens"][:, :-1]
        embed = self._outer(params, ("embed",))["embed"]
        x = embed_tokens(embed, cfg, tokens).to(cdt(cfg))
        pattern, _ = block_pattern(cfg)
        i = pattern.index("moe")
        router = {"router": params["slots"][i]["ffn"]["router"][0]}
        tp = hooks.tensor_parallel()
        if tp is not None:
            router = tp.gather_params(
                router, {"router": tp.shardings["slots"][i]["ffn"]["router"]},
                layers=True, whole=True)
        return aux_load_balance_loss(router, cfg, x)

    def prefill(self, params, batch, max_len: int | None = None):
        """Returns (last-token logits, decode-ready caches).  `max_len`
        reserves decode headroom in the KV caches (default: none).

        Under the tensor-parallel context (`models/train.py`
        `make_prefill`) `params` are this rank's blocks and `batch` the
        global batch: it computes this rank's rows (`batch_rows`) and
        returns their last-token logits over the whole vocab and its
        blocks of the caches (`self.cache_shardings` of the batch and
        `max_len`).  Each group's K and V are cut to their block as the
        group finishes."""
        tokens = batch["tokens"]
        B, S = tokens.shape[0], tokens.shape[1]
        max_len = max_len or S
        tp = hooks.tensor_parallel()
        sh = None
        if tp is not None:
            sh = self.cache_shardings(tp.mesh, B, max_len)
            batch = batch_rows(tp.mesh, batch)
            tokens = batch["tokens"]
        fresh = self.init_caches(B, max_len, mode="prefill",
                                 device=tokens.device, shardings=sh)
        pattern, _ = block_pattern(self.cfg)

        def to_cache(key, kv):
            if key == "shared_attn":
                f, s = fresh[key], sh and sh[key]
                return self._prefill_cache("attn", kv, f, s, S, ring=True)
            return self._prefill_cache(pattern[key], kv, fresh["slots"][key],
                                       sh and sh["slots"][key], S)

        logits, caches = self.forward(
            params, tokens, vision_embeds=batch.get("vision_embeds"),
            caches=fresh, mode="prefill", to_cache=to_cache)
        return _last_logits(logits), caches

    def _prefill_cache(self, slot, kv, fresh, sh, S: int, ring=False):
        """One group's prefill output of `slot` as its decode cache
        (`fresh`: the group's zero cache, whose dtypes and slots it takes):
        K and V in the cache's dtype, padded to its slots (with `ring`, the
        last of S tokens that fit, laid out to keep decode_attention's ring
        invariant slot == position % slots), their slot positions and
        `pos` = S; on a mesh (`sh`, the slot's cache shardings) cut to this
        rank's block.  The SSM states pass through."""
        if slot == "cross":
            return {k: kv[k].to(fresh[k].dtype) for k in ("k", "v")}
        if slot not in ("attn", "moe"):
            return kv
        dev = kv["k"].device
        size = fresh["slot_pos"].shape[-1]
        if ring and size < S:
            p_list = torch.arange(S - size, S, dtype=torch.int32, device=dev)
            order = torch.argsort(p_list % size)
            out = {k: kv[k][:, -size:][:, order].to(fresh[k].dtype)
                   for k in ("k", "v")}
            slot_pos = p_list[order]
        else:
            out = {k: _pad_seq(kv[k].to(fresh[k].dtype), size)
                   for k in ("k", "v")}
            slot_pos = torch.cat([
                torch.arange(S, dtype=torch.int32, device=dev),
                torch.full((size - S,), -1, dtype=torch.int32, device=dev)])
        if sh is not None:
            out = {k: self._cache_block(t, sh[k]) for k, t in out.items()}
        return {**out, "pos": torch.full((), S, dtype=torch.int32,
                                          device=dev),
                "slot_pos": slot_pos}

    @staticmethod
    def _cache_block(t, sh):
        """A group's K or V, (rows, slots, heads, head_dim) of this rank's
        rows, as its block of a cache laid out by `sh` (the stacked leaf's
        sharding): this rank's slots where the slots are split over
        "model" ("kv_seq"); else as it is, on this rank's heads
        ("kv_heads": `layers.attention` computes those alone) or whole."""
        tp = hooks.tensor_parallel()
        _, mdim = split_dims(sh, t.ndim + 1, tp.fsdp_axes)
        return local_slice(t, 1, tp.model) if mdim == 2 else t

    def decode_step(self, params, caches, tokens, cache_shardings=None):
        """tokens (B, 1[, n_cb]) -> (logits (B,1[,n_cb],V), new caches).
        The position comes from the caches; `positions` is a dummy.

        Under the tensor-parallel context (`models/train.py`
        `make_decode_step`) `params` and `caches` are this rank's blocks,
        the caches laid out by `cache_shardings`, and `tokens` the global
        batch's: it returns this rank's rows' logits over the whole vocab
        and its blocks of the new caches.  Where the FSDP axes split the
        rows, the MoE layers route the global batch's pool, as the
        reference does (`moe_ffn`'s `pool`)."""
        tp = hooks.tensor_parallel()
        pool = None
        if tp is not None:
            if cache_shardings is None:
                raise ValueError("a decode step on a mesh needs the caches' "
                                 "shardings (Model.cache_shardings)")
            rows = batch_rows(tp.mesh, {"tokens": tokens})["tokens"]
            if rows.shape[0] != tokens.shape[0]:
                pool = tp.fsdp
            tokens = rows
        logits, caches = self.forward(
            params, tokens, caches=caches, mode="decode",
            positions=torch.zeros((1,), dtype=torch.int32,
                                  device=tokens.device),
            cache_shardings=cache_shardings, moe_pool=pool)
        return _last_logits(logits), caches


def _pad_seq(x, target: int):
    """(B, S, ...) zero-padded to `target` slots on dim 1."""
    if x.shape[1] >= target:
        return x
    return torch.nn.functional.pad(
        x, (0, 0) * (x.ndim - 2) + (0, target - x.shape[1]))


def _last_logits(logits):
    """The last position's logits; a vocab-parallel head's gathered over
    "model" to the whole vocab after the slice."""
    split = hooks.model_split(logits) is not None
    last = logits[:, -1:]
    return hooks.tensor_parallel().gather_from_model(last, -1) if split \
        else last


def _rows_only(axes, keys: tuple, key: str | None = None):
    """A cache axes tree whose leaves named in `keys` keep their rows
    ("batch", dim 1 after "layers") and nothing on "model"; the rest as
    they are."""
    if isinstance(axes, dict):
        return {k: _rows_only(v, keys, k) for k, v in axes.items()}
    if key not in keys:
        return axes
    return ("layers", "batch") + (None,) * (len(axes) - 2)


def _own_heads(caches, ax):
    """An SSM slot's stacked states with each heads' state ((G, B, H, ...):
    `wkv`, `ssm`) narrowed to this rank's block of its heads on the
    "model" axis `ax` (views)."""
    out = {}
    for k, v in caches.items():
        if isinstance(v, dict):
            out[k] = _own_heads(v, ax)
        elif k in ("wkv", "ssm"):
            h = v.shape[2] // ax.size
            out[k] = v.narrow(2, ax.index * h, h)
        else:
            out[k] = v
    return out


def _rows_on_batch(axes):
    """A cache axes tree whose leaves put their rows (dim 1 after
    "layers") on "batch" and keep their other axes."""
    if isinstance(axes, dict):
        return {k: _rows_on_batch(v) for k, v in axes.items()}
    return ("layers", "batch") + tuple(axes[2:])


def _vocab_parallel_ce(logits, labels):
    """The mean cross-entropy of float32 logits split over "model" on their
    vocab dim: the max and the sum of exponentials reduced over "model",
    the label's logit taken on the rank that owns it (zero elsewhere) and
    summed; the max carries no gradient, as in `torch.logsumexp`."""
    tp = hooks.tensor_parallel()
    vl = logits.shape[-1]
    mx = tp.max_over_model(logits.detach().amax(dim=-1))
    sumexp = tp.reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(dim=-1))
    lse = torch.log(sumexp) + mx
    local = labels.long() - tp.model.index * vl
    own = (local >= 0) & (local < vl)
    picked = torch.take_along_dim(
        logits, local.clamp(0, vl - 1)[..., None], dim=-1)[..., 0]
    picked = tp.reduce_from_model(torch.where(own, picked, 0.0))
    return torch.mean(lse - picked)


def build_model(cfg: ModelConfig, run: RunConfig | None = None) -> Model:
    return Model(cfg=cfg, run=run or RunConfig())
