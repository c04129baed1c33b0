"""Multi-chip dry run: the port's counterpart of `repro/launch/dryrun.py`.

Counts every (architecture x input-shape x mesh) cell's step on `meta`
tensors (no allocation, no arithmetic) as rank 0 of a fake process group of
256 ranks (512 with the multi-pod mesh), under `hlo_cost.CostCounter`, and
appends a JSONL row per cell with the memory summary and the roofline terms
(`roofline.py`, against the H100's peaks):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Rows are keyed (arch, shape, mesh, tag); existing rows are skipped, so the
full sweep is resumable.  The fake group (`torch.distributed`'s "fake"
backend: collectives return at once and move nothing) exists only in this
process, which it refuses to start beside a real process group.  The dry
run never touches CUDA and needs no card: counting on `meta` is what it
is, as the reference's runs on 512 forced host devices, not a fallback.

What is counted is the port's own program:

  * train: the sharded step of `models/train.py` on this rank's blocks of
    the state (`launch/train.py`'s `state_shardings`), the reference's
    GSPMD program computed eagerly: each microbatch gathers a layer group's
    blocks over the FSDP axes as the group runs (and again in remat's
    recompute), computes the projections on their "model" blocks (an
    all-reduce over "model" after each row-parallel one and of the
    gradient of each column-parallel input; a MoE layer on this rank's
    experts, or every expert's block of hidden units, with one all-reduce
    of its partial output; the vision cross-attention on this rank's
    heads), the embedding and the loss
    over the vocab blocks, and reduce-scatters the gradients onto the FSDP
    blocks; `train_collective_bytes` gives each kind's bytes from the
    specs and the loop counts, and the tests hold the count to it;
  * prefill and decode: the sharded serving program of `models/train.py`
    (`make_prefill`, `make_decode_step` with the shardings), forward only,
    on this rank's param blocks (cast by `serve_param_dtype`), its rows of
    the global batch (`batch_shardings`) and, for decode, its blocks of
    caches filled to the cell's length (`Model.cache_shardings`: a KV
    cache's heads on "model", else its slots); each group gathers its
    blocks over the FSDP axes as it runs, computes the projections, the
    MoE layers and the cross-attention on their "model" blocks (an
    all-reduce after each row-parallel one; a decode step's MoE routing
    pooled over the global batch by an all-gather of the top-k indices
    over the FSDP axes), the
    vocab-parallel embedding and head (the last position's logits
    gathered over "model"), and a decode step over slots split over
    "model" combines its softmax there; `serve_collective_bytes` gives
    each kind's bytes, and the tests hold the count to it;
  * the embedding cell: `embed/distributed.py`'s 2-D tile and its
    all-reduces, on this rank's (N/R, N/C) tiles.

A cell whose direct count would dispatch more than `DIRECT_BUDGET_OPS` ops
(counted at its smallest fit point and scaled) is fitted (`hlo_cost.fit_cost`): its FLOPs,
bytes and collective bytes are polynomials in the layer groups G
(`models/model.py` `block_pattern`), of degree 1 for prefill and decode and
2 for train (the backward of each group's `params[g]` select writes a
gradient of the whole stacked block, and autograd adds the G of them: G^2
block-sized passes), of degree 1 in the microbatches M (M >= 2: one
microbatch skips the gradients' division), and, for the archs with a
Python time loop over the sequence (rwkv6, zamba2), of degree 1 in the
loop's trip count T: a step of the loop dispatches the same ops at every
step, forward and backward, so the cell runs at its own S with the loops
cut to T steps (`hooks.time_loop_limit`, on `meta` only; the steps cut
stand in as empty tensors) and T is fitted up to S.  The fit evaluates
them exactly at the cell's own G, M and T = S from G in {1, 2, 3}, M in
{2, 3} at the cell's rows a microbatch and T in LOOP_POINTS (three points:
a degree-2 fit, exact for the linear count); the row's `fitted` names the
points.  The sizes of arguments and outputs are exact too; the peak
(`temp_size_in_bytes`) is then an estimate, extended from the largest
point (the peak has a kink at G = 1, hence G's third point).
"""

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, EMBEDDING_ARCHS, RunConfig, SHAPES,
                                 get_config, shape_cells, skipped_cells)
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import batch_specs
from repro_torch.distributed.collectives import split_dims
from repro_torch.distributed.sharding import (batch_shardings, fsdp_axes,
                                              make_activation_constraint,
                                              tree_shardings)
from repro_torch.embed import EmbedMeshSpec, make_distributed_energy_grad
from repro_torch.launch import hlo_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.launch.train import state_shardings
from repro_torch.models import (block_pattern, build_model, hooks,
                                make_decode_step, make_prefill,
                                make_train_step, params_specs,
                                train_state_specs)
from repro_torch.models.model import whole_subtrees
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, tree_map

DOC = __doc__

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch.jsonl")
#: a cell is fitted when its direct count would dispatch more ops (about
#: 60 s at the ~100 us an op that a meta count takes on one host core)
DIRECT_BUDGET_OPS = 600_000
#: families whose models run a Python loop over the sequence (models/ssm.py)
TIME_LOOP_FAMILIES = ("ssm", "hybrid")
#: the trip counts at which those loops are counted (`hooks.time_loop_limit`)
LOOP_POINTS = (2, 3, 4)


def default_run_config(shape_name: str, overrides: dict | None = None
                       ) -> RunConfig:
    kw = dict(num_microbatches=8, remat="full", scan_layers=True,
              attn_q_chunk=1024, embed_onehot=True)
    if shape_name == "prefill_32k":
        kw.update(num_microbatches=1, attn_q_chunk=1024)
    if shape_name in ("decode_32k", "long_500k"):
        kw.update(num_microbatches=1, remat="none", attn_q_chunk=0)
    if overrides:
        kw.update(overrides)
    return RunConfig(**kw)


def _fake_group(world: int) -> None:
    """Rank 0 of a fake process group of `world` ranks in this process (one
    of another size that this module started is replaced); refuses a
    process that has a real group."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry run counts as rank 0 of a fake process group and "
                f"will not run in a process with a real one (backend "
                f"{dist.get_backend()!r}): run it in a process of its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError:                 # a torch without the module
        from torch._C._distributed_c10d import FakeProcessGroup
        dist.Backend.register_backend(
            "fake", lambda o, b: FakeProcessGroup._create_internal(
                o.group_rank, o.group_size, b),
            extended_api=True, devices=["cpu", "cuda"])
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=dist.HashStore())


@dataclasses.dataclass
class MetaCell:
    """A cell prepared on `meta`: `prepare(values)` gives `(fn, args)` at the
    loop counts `values` ({"groups", "microbatches", "seq"}: G, M, S; and
    "loop", the SSM time loops' trip count T, which `count_at` applies),
    `at` the cell's own, `grid` the fit points of each dim that may be
    fitted.  `count()` runs it under the counter, directly or fitted."""

    prepare: Callable[[dict], tuple]
    at: dict
    grid: dict
    grad: bool
    mesh: object
    run: RunConfig | None = None

    def count_at(self, values: dict) -> hlo_cost.Counted:
        """One direct count at `values` (the SSM time loops cut to
        `values["loop"]` steps where it is given)."""
        fn, args = self.prepare(values)
        hooks.set_activation_constraint(
            make_activation_constraint(self.mesh, self.run)
            if self.run is not None else None)
        try:
            with torch.set_grad_enabled(self.grad), \
                    hooks.time_loop_limit(values.get("loop")):
                _, counted = hlo_cost.count(fn, *args)
        finally:
            hooks.set_activation_constraint(None)
        return counted

    def count(self) -> hlo_cost.Counted:
        """Direct where that dispatches `DIRECT_BUDGET_OPS` ops or fewer
        (the grid's smallest point's ops, scaled by the loop counts), else
        the fit over the grid."""
        plan = {d: pts for d, pts in self.grid.items()
                if pts[-1] < self.at[d]}
        if not plan:
            return self.count_at(self.at)
        small = dict(self.at, **{d: pts[0] for d, pts in plan.items()})
        first = self.count_at(small)
        if first.n_ops * math.prod(self.at[d] / small[d] for d in plan) \
                <= DIRECT_BUDGET_OPS:
            return self.count_at(self.at)
        return hlo_cost.fit_cost(self.count_at, self.at, plan,
                                 first=(small, first),
                                 matmul_shapes="seq" not in plan)


def _lm_cell(cfg, shape: ShapeConfig, run: RunConfig, mesh) -> MetaCell:
    """The meta cell of one LM step on this rank's share: train (its state
    blocks, the global batch), prefill (its param blocks, the global
    batch) or decode (its param and cache blocks, the global batch's
    tokens)."""
    pattern, n_groups = block_pattern(cfg)
    nmb = run.num_microbatches if shape.mode == "train" else 1
    rows = shape.global_batch // nmb

    def prepare(v: dict) -> tuple:
        c = dataclasses.replace(cfg, num_layers=v["groups"] * len(pattern))
        r = dataclasses.replace(run, num_microbatches=v["microbatches"])
        sh_ = ShapeConfig(shape.name, shape.mode, v["seq"],
                          rows * v["microbatches"])
        model = build_model(c, r)
        batch = batch_specs(c, sh_)
        if shape.mode == "train":
            specs, axes = train_state_specs(model)
            sh = state_shardings(mesh, axes, specs)
            state = tree_map(lambda s, x: s.shard(x), sh, specs)
            # the port's step is data-parallel on any mesh, so it always
            # takes the shardings (run.zero_grads has no meaning there)
            step = make_train_step(
                model, AdamWConfig(moment_dtype=r.moment_dtype),
                grad_shardings=sh["params"])
            return step, (state, batch)
        params, psh = serve_params(model, mesh)
        if shape.mode == "prefill":
            return make_prefill(model, psh), (params, batch)
        tokens = batch["tokens"]
        csh = model.cache_shardings(mesh, tokens.shape[0], sh_.seq_len)
        caches = tree_map(
            lambda s, x: s.shard(x.contiguous()),   # blocks, not broadcasts
            csh, model.init_caches(tokens.shape[0], sh_.seq_len,
                                   mode="decode", device="meta"))
        return make_decode_step(model, psh, csh), (params, caches, tokens)

    at = {"groups": n_groups, "microbatches": nmb, "seq": shape.seq_len}
    grid = {"groups": (1, 2, 3)}
    if nmb >= 2:
        grid["microbatches"] = (2, 3)
    if cfg.family in TIME_LOOP_FAMILIES and shape.mode != "decode":
        at["loop"] = shape.seq_len
        grid["loop"] = LOOP_POINTS
    return MetaCell(prepare, at, grid, shape.mode == "train", mesh, run)


def train_collective_bytes(cfg, run: RunConfig, mesh, global_batch: int,
                           seq: int) -> dict[str, int]:
    """The bytes of each collective kind that a rank's sharded train step
    moves (each op's operand bytes, as `hlo_cost` counts them), from the
    params' specs on `mesh` (only its shape is read) and the loop counts:
    M microbatches, G layer groups, remat's second forward (P = 2 passes,
    else 1), b = this rank's rows of a microbatch, S, D, m = the "model"
    axis, F = the FSDP axes' product, c = the compute dtype's bytes.

      all-gather: a group leaf's FSDP block P M times (once a group: the
        stacked block's bytes), the embedding, final norm and head blocks
        M times; the leaves of an SSM slot whose heads do not divide over
        "model" (`whole_subtrees`) over "model" too (the FSDP-whole
        block); attention's k and v (q too where H does not divide over
        "model") of P M calls, and the gradient of the scattered output,
        the vision cross-attention's alike with k and v over its image
        tokens (bf16, the vision embeddings' dtype); a MoE layer's router
        block over "model" P M times where the router is split there;
      reduce-scatter: F times each FSDP gather's block M times, k and v
        whole where only q is on this rank's heads, and the whole router M
        times where the experts and the router are split over "model";
      all-reduce: each row-parallel output (b, S, D) P M times (the
        group's last, when an MLP's or a MoE layer's, M times: the
        recompute stops before it; a MoE layer's experts and shared expert
        share one), each
        column-parallel input's gradient M times (a MoE layer's input's
        too; the cross-attention's image tokens take none), the
        vocab-parallel embedding, head input and the loss's three (b, S)
        f32 reductions M times, the gradient of each FSDP-whole leaf M
        times (and of a router whole on "model" where the experts are
        split there), and the step's loss and norm scalars;
      the SSM slots on a rank's heads: `_ssm_heads`' bytes M times.
    """
    model = build_model(cfg, run)
    specs, axes = params_specs(model)
    sh = tree_shardings(mesh, axes, specs)
    fsdp = fsdp_axes(mesh)
    F = math.prod(mesh.shape[a] for a in fsdp)
    m = mesh.shape.get("model", 1)
    pattern, G = block_pattern(cfg)
    M = run.num_microbatches
    P = 2 if run.remat == "full" else 1
    rows = global_batch // M
    b = rows // F if rows % F == 0 else rows
    c = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                    ).element_size()
    D, S, H, KV, hd = (cfg.d_model, seq, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}

    def params(tree, shard_tree, fwd: int, bwd: int, whole=False,
               per: int = 1):
        for p, s in zip(leaves(tree), leaves(shard_tree)):
            fdim, mdim = split_dims(s, p.ndim, fsdp)
            block = p.numel() * p.element_size() // per
            block //= (F if fdim is not None else 1) * (
                m if mdim is not None else 1)
            if fdim is not None:
                out["all-gather"] += fwd * block
                out["reduce-scatter"] += bwd * F * block
            elif F > 1:
                out["all-reduce"] += bwd * block
            if mdim is not None and whole:
                out["all-gather"] += fwd * block * (
                    F if fdim is not None else 1)

    for slot, p, s in zip(pattern, specs["slots"], sh["slots"]):
        whole = whole_subtrees(cfg, slot, m)
        for k in p:
            params(p[k], s[k], P * M, M, k in whole)
    for k, v in _ssm_heads(cfg, specs, sh, fsdp, m, b, S, c, P).items():
        out[k] += M * v
    attn = G * sum(slot in ("attn", "moe") for slot in pattern)
    mlps = G * sum(slot in ("attn", "cross") for slot in pattern)
    if cfg.family == "hybrid":
        params(specs["shared_attn"], sh["shared_attn"], P * M * G, M * G)
        attn += G
        mlps += G
    for k in ("embed", "final_ln", "head"):
        params(specs[k], sh[k], M, M)
    bSD = b * S * D * c
    if m > 1:
        qs, ks = H * hd % m == 0, KV * hd % m == 0
        act = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
        if qs != ks:
            raise NotImplementedError(
                "the q and kv projections split differently over 'model' "
                "(their weights are gathered): not counted here")
        if qs:
            act["all-reduce"] += bSD                  # the input's gradient
            if H % m:                                 # every head whole
                act["all-gather"] += P * b * S * (H + 2 * KV) * hd // m * c
                act["all-gather"] += b * S * H * hd // m * c  # out's grad
            elif KV % m:                              # k and v whole
                act["all-gather"] += P * b * S * 2 * KV * hd // m * c
                act["reduce-scatter"] += b * S * 2 * KV * hd * c
            act["all-reduce"] += P * bSD              # wo, row-parallel
        for k, v in act.items():
            out[k] += attn * M * v
        if cfg.d_ff % m == 0:
            out["all-reduce"] += mlps * M * (1 + P) * bSD
            if P == 2 and pattern[-1] in ("attn", "cross"):
                # remat's recompute stops at the group's last saved tensor
                # (torch.utils.checkpoint's early stop): before the last
                # MLP's output projection and its all-reduce
                out["all-reduce"] -= G * M * bSD
        if cfg.vocab_size % m == 0:
            ncb = max(cfg.n_codebooks, 1)
            emb = 1 if run.embed_onehot else ncb
            out["all-reduce"] += M * (emb * bSD + bSD + 3 * b * S * ncb * 4)
            if cfg.num_experts:
                out["all-reduce"] += M * rows * S * D * c   # the aux lookup
        cross = G * pattern.count("cross")
        if qs and cross:
            for k, v in _cross_attention(cfg, b, S, m, c, P).items():
                out[k] += cross * M * v
        moe = _moe_layout(cfg, specs, sh, fsdp, m)
        if moe is not None:
            moes, split, router_block = moe
            if split:
                # the partial outputs' sum P M times (the group's last
                # slot's M times: the recompute stops before it) and the
                # input's gradient M times
                out["all-reduce"] += moes * M * (P + 1) * bSD
                if P == 2 and pattern[-1] == "moe":
                    out["all-reduce"] -= G * M * bSD
            if router_block:             # the router gathered over "model"
                out["all-gather"] += moes * P * M * router_block
                if split:
                    out["reduce-scatter"] += moes * M * m * router_block
            elif split:                  # whole there, its gradient summed
                out["all-reduce"] += moes * M * _router_bytes(specs, pattern,
                                                              G)
    if cfg.num_experts:                 # the aux loss's embedding and router
        params(specs["embed"], sh["embed"], M, M)
        i = pattern.index("moe")
        params(specs["slots"][i]["ffn"]["router"],
               sh["slots"][i]["ffn"]["router"], M, M, True, per=G)
    if run.grad_compress and M > 1 and F * m > 1:
        out["all-reduce"] += M * 4 * len(leaves(specs))
    out["all-reduce"] += 4 * (F > 1) + 4 * (F * m > 1)
    return out


def _serve_specs(model) -> tuple:
    """The params on `meta`, cast by the run's `serve_param_dtype`, and
    their logical axes."""
    params, axes = params_specs(model)
    if model.run.serve_param_dtype != "float32":
        sdt = getattr(torch, model.run.serve_param_dtype)
        params = tree_map(lambda p: p.to(sdt)
                          if p.dtype == torch.float32 else p, params)
    return params, axes


def serve_params(model, mesh) -> tuple:
    """(this rank's blocks of the serving params on `meta`, their
    `NamedSharding` tree on `mesh`)."""
    params, axes = _serve_specs(model)
    sh = tree_shardings(mesh, axes, params)
    return tree_map(lambda s, x: s.shard(x), sh, params), sh


def serve_collective_bytes(cfg, run: RunConfig, mesh, global_batch: int,
                           seq: int, mode: str) -> dict[str, int]:
    """The bytes of each collective kind that a rank's sharded prefill
    (`mode` "prefill": S = `seq` tokens) or decode step ("decode": one
    token against caches of `seq` slots) moves, each op's operand bytes
    as `hlo_cost` counts them, from the params' specs (cast by
    `serve_param_dtype`) and the caches' on `mesh` (only its shape is
    read): G layer groups, b = this rank's rows, D, m = the "model" axis,
    c = the compute dtype's bytes, T = the tokens a row computes (S, or 1).

      all-gather: a group leaf's FSDP block once a group, the embedding,
        final norm and head blocks once, the leaves of an SSM slot whose
        heads do not divide over "model" over "model" too; q (where H does
        not divide over "model") and k and v (where KV does not) of each
        attention call, the vision
        cross-attention's alike (its prefill's k and v over the image
        tokens, in the vision embeddings' dtype; its decode step reads
        them from the cache); a decode step on slots split over "model"
        gathers q where it is on this rank's heads; a MoE layer's router
        block where the router is split over "model"; a decode step whose
        rows the FSDP axes split, each MoE layer's pooled top-k indices
        (b, k) int64 over the FSDP axes; the last position's
        vocab-parallel logits;
      all-reduce: each row-parallel output (b, T, D) (attention's wo, the
        MLPs', a MoE layer's partial sum over its experts and shared
        expert), the vocab-parallel embedding; a decode step on split
        slots, the scores' max (b, H) and the combined p v and sum of
        exps (b, H, hd + 1), float32, an attention call;
      the SSM slots on a rank's heads: `_ssm_heads`' bytes of a call.
    """
    model = build_model(cfg, run)
    specs, axes = _serve_specs(model)
    sh = tree_shardings(mesh, axes, specs)
    fsdp = fsdp_axes(mesh)
    F = math.prod(mesh.shape[a] for a in fsdp)
    m = mesh.shape.get("model", 1)
    pattern, G = block_pattern(cfg)
    b = global_batch // F if global_batch % F == 0 else global_batch
    T = seq if mode == "prefill" else 1
    c = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                    ).element_size()
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}

    def params(tree, shard_tree, times: int, whole=False):
        for p, s in zip(leaves(tree), leaves(shard_tree)):
            fdim, mdim = split_dims(s, p.ndim, fsdp)
            block = p.numel() * p.element_size()
            block //= (F if fdim is not None else 1) * (
                m if mdim is not None else 1)
            if fdim is not None:
                out["all-gather"] += times * block
            if mdim is not None and whole:
                out["all-gather"] += times * block * (
                    F if fdim is not None else 1)

    for slot, p, s in zip(pattern, specs["slots"], sh["slots"]):
        whole = whole_subtrees(cfg, slot, m)
        for k in p:
            params(p[k], s[k], 1, k in whole)
    for k, v in _ssm_heads(cfg, specs, sh, fsdp, m, b, T, c, 0).items():
        out[k] += v
    mlps = G * sum(slot in ("attn", "cross") for slot in pattern)
    if cfg.family == "hybrid":
        params(specs["shared_attn"], sh["shared_attn"], G)
        mlps += G
    for k in ("embed", "final_ln", "head"):
        params(specs[k], sh[k], 1)
    moes = G * pattern.count("moe")
    if (mode == "decode" and moes and run.moe_decode_pool and F > 1
            and global_batch % F == 0):
        # the pooled routing's top-k indices (int64) over the FSDP axes
        out["all-gather"] += moes * b * cfg.experts_per_token * 8
    if m == 1:
        return out
    # the attention calls on split projections: (calls, their KV cache's
    # shardings)
    csh = model.cache_shardings(mesh, global_batch, seq)
    kv = [i for i, slot in enumerate(pattern) if slot in ("attn", "moe")]
    calls = [(G * len(kv), csh["slots"][kv[0]])] if kv else []
    if cfg.family == "hybrid":
        calls.append((G, csh["shared_attn"]))
    qs, ks = H * hd % m == 0, KV * hd % m == 0
    if qs != ks:
        raise NotImplementedError(
            "the q and kv projections split differently over 'model' "
            "(their weights are gathered): not counted here")
    bTD = b * T * D * c
    for n, cache in calls:
        split = split_dims(cache["k"], 5, fsdp)[1] if mode == "decode" \
            else None
        per = {"all-gather": 0, "all-reduce": 0}
        if qs:
            if H % m:
                per["all-gather"] += b * T * H * hd // m * c
            if KV % m:
                per["all-gather"] += 2 * b * T * KV * hd // m * c
            per["all-reduce"] += bTD                       # wo
        if split == 2:                                     # "kv_seq"
            if qs and H % m == 0:
                per["all-gather"] += b * H * hd // m * c   # q to every head
            per["all-reduce"] += b * H * 4 + b * H * (hd + 1) * 4
        for k, v in per.items():
            out[k] += n * v
    cross = G * pattern.count("cross")
    if qs and cross:
        per = {"all-gather": 0, "all-reduce": bTD}          # wo
        if H % m:
            per["all-gather"] += b * T * H * hd // m * c
        if KV % m and mode == "prefill":      # decode reads the cache
            per["all-gather"] += 2 * b * cfg.n_image_tokens * KV * hd // m \
                * _VISION_BYTES
        for k, v in per.items():
            out[k] += cross * v
    moe = _moe_layout(cfg, specs, sh, fsdp, m)
    if moe is not None:
        _, split, router_block = moe
        if split:
            out["all-reduce"] += moes * bTD
        out["all-gather"] += moes * router_block
    if cfg.d_ff % m == 0:
        out["all-reduce"] += mlps * bTD
    if cfg.vocab_size % m == 0:
        ncb = max(cfg.n_codebooks, 1)
        emb = 1 if run.embed_onehot else ncb
        out["all-reduce"] += emb * bTD
        out["all-gather"] += b * ncb * cfg.vocab_size // m * c
    return out


def _ssm_heads(cfg, specs, sh, fsdp, m: int, b: int, T: int, c: int,
               P: int) -> dict:
    """The collectives' bytes of the SSM slots that compute on a rank's
    heads (`models/ssm.py`; a slot whose heads do not divide over "model"
    computes whole: its gathers are the params') in one microbatch of the
    train step (`P` passes of the forward, remat's recompute among them,
    and the backward) or one serving call (`P` = 0: the forward once, no
    backward), over b rows of T tokens (T = 1 a decode step) of D
    elements of c bytes, a layer:

      RWKV6: the row-parallel `wo`'s all-reduce a pass; the channel mix's
        reduce-scatter of k @ wv a pass (where `wv` is split over "model";
        else a slice) and its all-gather of y, once (the recompute stops
        before it: no tensor after it is saved), the backward's all-gather
        of the reduce-scatter's gradient; the backward's all-reduces of
        the column-parallel inputs' gradients (r, k, v, g, the decay LoRA's
        output, the channel mix's r and, where `wk` is split, its k) and
        of `ln_scale`'s (D in the params' dtype);
      Mamba2: `in_proj`, `conv_w` and `conv_b` gathered over "model" a
        pass (their blocks, where split there), their gradients
        reduce-scattered (all-reduced where whole there); x's gradient's
        all-reduce; the RMSNorm's sum of squares (b, T, 1) f32 all-reduced
        a pass and in the backward; the row-parallel `out_proj`'s
        all-reduce a pass, once for the group's last slot (the recompute
        stops before it); a serving call all-gathers the new conv rows of
        the rank's x channels, (b, K - 1, d_inner / m) in the cache's
        bf16."""
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    pattern, G = block_pattern(cfg)
    if m == 1:
        return out
    bTD = b * T * cfg.d_model * c
    fwd, bwd = max(P, 1), 1 if P else 0
    for i, slot in enumerate(pattern):
        if slot not in ("rwkv", "mamba") or whole_subtrees(cfg, slot, m):
            continue
        last = fwd if (P < 2 or i < len(pattern) - 1) else 1
        if slot == "rwkv":
            cm, csh = specs["slots"][i]["cm"], sh["slots"][i]["cm"]
            wv = split_dims(csh["wv"], cm["wv"].ndim, fsdp)[1] is not None
            ln = specs["slots"][i]["tm"]["ln_scale"]
            layer = {"all-reduce": fwd * bTD + bwd * (
                (6 + wv) * bTD + ln.numel() // G * ln.element_size()),
                "reduce-scatter": fwd * bTD if wv else 0,
                "all-gather": (last * bTD + bwd * bTD) // m}
        else:
            mx, msh = specs["slots"][i]["mixer"], sh["slots"][i]["mixer"]
            layer = {"all-gather": 0, "reduce-scatter": 0,
                     "all-reduce": bwd * bTD + (fwd + bwd) * b * T * 4
                     + last * bTD}
            for k in ("in_proj", "conv_w", "conv_b"):
                nbytes = mx[k].numel() // G * mx[k].element_size()
                if split_dims(msh[k], mx[k].ndim, fsdp)[1] is not None:
                    layer["all-gather"] += fwd * nbytes // m
                    layer["reduce-scatter"] += bwd * nbytes
                else:
                    layer["all-reduce"] += bwd * nbytes
            if not P:
                layer["all-gather"] += (b * (cfg.ssm_conv - 1) * 2
                                        * cfg.d_model // m * 2)
        for k, v in layer.items():
            out[k] += G * v
    return out


#: the bytes of an element of the vision embeddings (`data.batch_specs`:
#: bf16 at any compute dtype), which the cross-attention's k and v inherit
_VISION_BYTES = torch.empty((), dtype=torch.bfloat16).element_size()


def _cross_attention(cfg, b: int, S: int, m: int, c: int, P: int) -> dict:
    """The collectives' bytes of one vision cross-attention call of the
    train step on "model" blocks (q over S tokens, k and v over the image
    tokens, in the vision embeddings' dtype): the gathers of what stays
    whole and the conjugates of the backward, as self-attention's."""
    H, KV, hd, Ti = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                     cfg.n_image_tokens)
    cv = _VISION_BYTES
    bSD = b * S * cfg.d_model * c
    out = {"all-gather": 0, "reduce-scatter": 0,
           "all-reduce": bSD + P * bSD}        # x's gradient; wo
    if H % m:                                  # every head whole
        out["all-gather"] += P * (b * S * H * hd // m * c
                                  + 2 * b * Ti * KV * hd // m * cv)
        out["all-gather"] += b * S * H * hd // m * c      # out's grad
    elif KV % m:                               # k and v whole
        out["all-gather"] += P * 2 * b * Ti * KV * hd // m * cv
        out["reduce-scatter"] += 2 * b * Ti * KV * hd * cv
    return out


def _router_bytes(specs, pattern, G: int) -> int:
    """One layer group's whole router, in the params' dtype."""
    r = specs["slots"][pattern.index("moe")]["ffn"]["router"]
    return r.numel() * r.element_size() // G


def _moe_layout(cfg, specs, sh, fsdp, m: int):
    """None without MoE slots or a "model" axis; else (the MoE layers, G
    times the slots; whether a layer's output is partial over "model":
    its experts or its shared expert split there; the bytes of one
    group's router block over "model" that the layer gathers, 0 where the
    router is whole there)."""
    pattern, G = block_pattern(cfg)
    if m == 1 or "moe" not in pattern:
        return None
    i = pattern.index("moe")
    ffn, fsh = specs["slots"][i]["ffn"], sh["slots"][i]["ffn"]

    def on_model(key, sub=None):
        p, s = (ffn[key], fsh[key]) if sub is None else (ffn[sub][key],
                                                         fsh[sub][key])
        return split_dims(s, p.ndim, fsdp)[1] is not None

    split = on_model("wi_gate") or ("shared" in ffn
                                    and on_model("wi_gate", "shared"))
    block = (_router_bytes(specs, pattern, G) // m if on_model("router")
             else 0)
    return G * pattern.count("moe"), split, block


def lower_cell(arch: str, shape_name: str, mesh, run_overrides=None):
    """Returns (the prepared meta cell, MODEL_FLOPS).  Nothing is lowered:
    the cell is run under the counter by `MetaCell.count`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    run = default_run_config(shape_name, run_overrides)
    return _lm_cell(cfg, shape, run, mesh), rl.model_flops_for(cfg, shape)


def _embedding_cell(cfg, mesh, run_overrides=None) -> tuple:
    """(meta cell, MODEL_FLOPS) of one distributed energy-and-gradient
    evaluation of `cfg` (an `EmbeddingConfig`) on `mesh`."""
    ov = run_overrides or {}
    unit_wm = bool(ov.get("embed_unit_wm", False))
    wp_dtype = getattr(torch, ov.get("embed_wp_dtype", "float32"))
    rows = fsdp_axes(mesh)
    spec = EmbedMeshSpec(row_axes=rows, col_axis="model")
    row_groups = math.prod(mesh.shape[a] for a in rows)
    cols = mesh.shape["model"]
    lcm = math.lcm(row_groups, cols)
    n = -(-cfg.n_points // lcm) * lcm     # pad N to a shardable size
    eg = make_distributed_energy_grad(mesh, spec, cfg.kind, unit_wm=unit_wm)

    def prepare(v: dict) -> tuple:
        X = torch.empty((n, cfg.embed_dim), device="meta")
        W = [torch.empty((n // row_groups, n // cols), dtype=wp_dtype,
                         device="meta") for _ in range(1 if unit_wm else 2)]
        lam = torch.empty((), device="meta")
        return eg, (X, *W, lam)

    # model flops: one fused pairwise pass = ~6 N^2 (d + kernel math)
    mflops = 6.0 * n * n * (cfg.embed_dim + 4)
    return MetaCell(prepare, {}, {}, False, mesh), mflops


def lower_embedding_cell(arch: str, mesh, run_overrides=None):
    """The paper's own workload on the production mesh: one distributed
    energy-and-gradient evaluation (the 2-D tile, its all-reduces), the
    reference's cell.  Returns (the prepared meta cell, MODEL_FLOPS).

    Overrides (hillclimb knobs): {"embed_unit_wm": true} drops the O(N^2)
    W- storage (recomputed from distances); {"embed_wp_dtype": "bfloat16"}
    halves the W+ stream."""
    return _embedding_cell(get_config(arch), mesh, run_overrides)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_path: str,
             tag: str = "baseline", run_overrides=None, verbose=True):
    _fake_group(512 if mesh_kind == "multi" else 256)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.perf_counter()
    if arch in EMBEDDING_ARCHS:
        cell, mflops = lower_embedding_cell(arch, mesh, run_overrides)
    else:
        cell, mflops = lower_cell(arch, shape_name, mesh, run_overrides)
    t_lower = time.perf_counter() - t0
    t0 = time.perf_counter()
    counted = cell.count()
    t_compile = time.perf_counter() - t0
    roof = rl.analyze(counted.cost, n_chips(mesh), mflops)
    mem = dict(counted.memory)
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "chips": int(n_chips(mesh)),
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "memory": mem,
        **roof.as_dict(),
        "fitted": counted.fitted,
    }
    if verbose:
        print(f"== {arch} x {shape_name} x {mesh_kind} [{tag}] ==")
        print(f"  prepare {t_lower:.1f}s count {t_compile:.1f}s "
              f"({counted.n_ops:.0f} ops"
              + (f", fitted over {counted.fitted}" if counted.fitted else "")
              + ")")
        if arch not in EMBEDDING_ARCHS:
            cfg, m = get_config(arch), mesh.shape.get("model", 1)
            whole = sorted({s for s in block_pattern(cfg)[0]
                            if whole_subtrees(cfg, s, m)})
            if whole:
                print(f"  whole on 'model' (heads do not divide over {m}):"
                      f" every head of {whole} on every rank")
        print(f"  memory: {mem}")
        print(f"  cost: flops/chip={roof.flops_per_chip:.3e} "
              f"bytes/chip={roof.bytes_per_chip:.3e} "
              f"coll bytes/chip={roof.collective_bytes_per_chip:.3e}")
        print(f"  terms: compute={roof.compute_s:.4f}s "
              f"memory={roof.memory_s:.4f}s "
              f"collective={roof.collective_s:.4f}s -> {roof.dominant}")
        print(f"  MODEL_FLOPS={mflops:.3e} useful_ratio={roof.useful_ratio:.3f}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    return row


def existing_keys(out_path: str) -> set:
    keys = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    keys.add((r["arch"], r["shape"], r["mesh"],
                              r.get("tag", "baseline")))
                except json.JSONDecodeError:
                    continue
    return keys


def main(argv=None):
    ap = argparse.ArgumentParser(description=DOC.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--overrides", default=None,
                    help="JSON RunConfig overrides, e.g. "
                         '\'{"num_microbatches": 16}\'')
    args = ap.parse_args(argv)
    overrides = json.loads(args.overrides) if args.overrides else None
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    try:
        if args.all:
            done = existing_keys(args.out)
            cells = []
            for arch in ARCH_IDS:
                for sc in shape_cells(arch):
                    for mk in meshes:
                        cells.append((arch, sc.name, mk))
            for arch, sname, mk in cells:
                if (arch, sname, mk, args.tag) in done:
                    print(f"skip {arch} x {sname} x {mk} (done)")
                    continue
                try:
                    run_cell(arch, sname, mk, args.out, tag=args.tag,
                             run_overrides=overrides)
                except Exception:
                    print(f"FAILED {arch} x {sname} x {mk}")
                    traceback.print_exc()
            # record the assignment-mandated skips
            for arch in ARCH_IDS:
                for sc, why in skipped_cells(arch):
                    print(f"SKIP-CELL {arch} x {sc.name}: {why}")
            return 0

        if not args.arch or not (args.shape or args.arch in EMBEDDING_ARCHS):
            ap.error("--arch and --shape (or --all) are needed; an "
                     "embedding arch needs no --shape")
        for mk in meshes:
            run_cell(args.arch, args.shape, mk, args.out, tag=args.tag,
                     run_overrides=overrides)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
