"""Train-step and serve-step factories.

Port of `repro/models/train.py`.  `train_step` = microbatched value and
gradient (float32 accumulation in the reference's order, optional int8
error-feedback compression) + AdamW.  The reference's step is one jitted
program that donates its state; the port's runs eagerly and updates the
state's tensors in place (`adamw.update(..., donate=True)`): the returned
state holds the same tensors, and the caller keeps no older copy.

Gradients.  A microbatch's loss is differentiated by autograd with respect
to detached aliases of the params; without compression the microbatches'
gradients accumulate in the aliases' ``.grad`` (the first microbatch's
gradient is the accumulator, and each later one is added in float32, the
reference's ``0 + g0 + g1 + ...`` bit for bit), so no second
gradient-sized buffer is held.  With compression each microbatch's
gradient is quantized before it is added, as the reference does.

On a mesh (`grad_shardings`, a tree of `distributed.sharding.NamedSharding`
matching the params) the state holds this rank's blocks of params and
moments, and a step is the reference's GSPMD program, computed eagerly:

  1. every rank is handed the same global batch and computes the loss on
     its rows of each microbatch (`batch_rows`; ranks that differ only
     on "model" take the same rows), with the MoE load-balance term over
     the whole microbatch, so that the mean over the FSDP group is the
     microbatch's loss;
  2. under the tensor-parallel context (`hooks.tensor_parallel_scope`,
     `distributed.collectives.TensorParallel`) the model gathers a layer
     group's blocks over the FSDP axes just before the group runs (again
     in remat's recompute), computes each projection on its "model" block
     and the loss over the vocab blocks (`models/layers.py`,
     `models/moe.py`, `models/model.py`); no rank holds a whole leaf that
     its spec splits, bar the leaves that `ssm.py` reads directly, gathered
     over "model" at their group, and a MoE layer's router, which every
     rank routes with whole;
  3. the backward reduce-scatters each gathered leaf's gradient onto its
     FSDP blocks (summed over the FSDP group; divided by its size here):
     each alias's ``.grad`` is this rank's block;
  4. `global_norm` sums the blocks' squares, each block that several ranks
     hold alike once, over every rank; the update runs on the blocks.

The result is the reference's step up to the order of its sums.  Under an
active telemetry tracer (`repro_torch.obs`) a step runs the spans
``train/microbatch`` (a microbatch's forward and backward) and
``train/optimizer``; they time the host's issue, and with
`profiler_annotations` a `torch.profiler` capture attributes the device's
kernels to them.

Serving on a mesh (`make_prefill` and `make_decode_step` with the
shardings) is the same program forward only, under `torch.no_grad()`: each
rank takes its rows of the global batch, gathers a group's blocks as the
group runs and keeps its blocks of the KV caches, on its kv heads or its
slice of the slots (`Model.cache_shardings`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import TensorParallel
from repro_torch.distributed.sharding import batch_rows
from repro_torch.obs import span
from repro_torch.optim import adamw
from repro_torch.optim.compress import compress_with_feedback, init_feedback
from repro_torch.tree import flatten, leaves

from . import hooks
from .model import Model


def init_train_state(model: Model, key, device=None) -> tuple[dict, dict]:
    """Returns (state, axes). state = {params, opt, step}; `step` and the
    optimizer's `count` are int32 scalars on the params' device.  `key` and
    `device` as `Model.init_params`'s (on `meta`: shapes only)."""
    params, axes = model.init_params(key, device=device)
    opt = adamw.init(params, moment_dtype=model.run.moment_dtype)
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32,
                                 device=leaves(params)[0].device)}
    return state, axes


def train_state_specs(model: Model, key=None):
    """`init_train_state` on the `meta` device (the reference's
    `jax.eval_shape`: shapes and dtypes, no allocation, no draw) + the
    logical axes tree."""
    return init_train_state(model, key or 0, device="meta")


def params_specs(model: Model, key=None):
    """`meta` tensors of the params' shapes and dtypes + the logical axes
    tree (no allocation, no draw)."""
    return model.init_params(key or 0, device="meta")


def _microbatches(batch: dict, nmb: int) -> list[dict]:
    """The reference's ``x.reshape((nmb, B // nmb) + ...)``: microbatch i
    is rows [i B/nmb, (i + 1) B/nmb) of every leaf (views)."""
    if nmb == 1:
        return [batch]
    size = {k: v.shape[0] // nmb for k, v in batch.items()}
    return [{k: v[i * size[k]:(i + 1) * size[k]] for k, v in batch.items()}
            for i in range(nmb)]


class _Sharded:
    """What a step on a mesh needs of `grad_shardings`: the tensor-parallel
    context, the FSDP mean and the norm over blocks."""

    def __init__(self, grad_shardings):
        self.shardings = leaves(grad_shardings)
        self.mesh = self.shardings[0].mesh
        self.tp = TensorParallel(self.mesh, grad_shardings)
        # a block counts towards the norm on the ranks at coordinate 0 of
        # every axis of the mesh that its spec does not split it over
        coords = self.mesh.coords
        self.counted = [all(coords[a] == 0 for a in self.mesh.axis_names
                            if a not in s.axes) for s in self.shardings]

    @property
    def n(self) -> int:
        return self.tp.fsdp.size

    def mean(self, tensors) -> None:
        """Each tensor (in place) averaged over the FSDP group."""
        if self.n == 1:
            return
        for t in tensors:
            dist.all_reduce(t, group=self.tp.fsdp.group)
            t.div_(self.n)

    def divide(self, grads) -> None:
        """The blocks' gradients, summed over the FSDP group by the
        reduce-scatters, made its mean (in place)."""
        if self.n > 1:
            for g in grads:
                g.div_(self.n)

    def global_norm(self, grads) -> torch.Tensor:
        """`adamw.global_norm` of the whole gradient from the blocks: this
        rank's counted blocks' squares in leaf order, summed over every
        rank (one all-reduce of a scalar; the same bits on each)."""
        sq = sum(torch.sum(torch.square(g.float()))
                 for g, c in zip(grads, self.counted) if c)
        if not torch.is_tensor(sq):
            sq = torch.zeros((), device=grads[0].device)
        if self.mesh.size > 1:
            dist.all_reduce(sq)
        return torch.sqrt(sq)

    def max_over_ranks(self, amax: torch.Tensor) -> torch.Tensor:
        """The leaves' largest |g| (one a leaf) over every rank: each
        whole leaf's, from its blocks (the int8 compression's scales)."""
        if self.mesh.size > 1:
            dist.all_reduce(amax, op=dist.ReduceOp.MAX)
        return amax


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    grad_shardings=None):
    """The train step `(state, batch) -> (state, {"loss", "grad_norm",
    "lr"})`.  `grad_shardings`: the params' `NamedSharding` tree on a mesh,
    whose blocks the state then holds and whose gradients the step
    reduce-scatters onto them (the sharded step of the module docstring)."""
    run = model.run
    dp = _Sharded(grad_shardings) if grad_shardings is not None else None

    def loss_fn(p, mb):
        if dp is None:
            return model.train_loss(p, mb)
        loss = model._token_loss(p, batch_rows(dp.mesh, mb))
        if model.cfg.num_experts:
            loss = loss + 0.01 * model._moe_aux(p, mb)
        return loss

    def train_step(state, batch):
        flat_p, rebuild, _ = flatten(state["params"])
        alias = [p.detach().requires_grad_(True) for p in flat_p]
        params = rebuild(alias)

        nmb = run.num_microbatches
        compress = run.grad_compress and nmb > 1
        err = init_feedback(flat_p) if compress else None
        gacc, lsum = None, None
        with hooks.tensor_parallel_scope(dp.tp if dp else None):
            for mb in _microbatches(batch, nmb):
                with span("train/microbatch"):
                    loss = loss_fn(params, mb)
                    if compress:
                        g = list(torch.autograd.grad(loss, alias))
                        if dp is not None:
                            dp.divide(g)
                        g, err = compress_with_feedback(
                            g, err, dp.max_over_ranks if dp else None)
                        if gacc is None:
                            gacc = g
                        else:
                            for a, x in zip(gacc, g):
                                a.add_(x)
                    else:
                        loss.backward(inputs=alias)
                loss = loss.detach()
                lsum = loss if lsum is None else lsum + loss
        del err
        if compress:
            grads = gacc
        else:
            # a param the loss does not reach has no .grad: JAX's is zeros
            grads = [a.grad if a.grad is not None else torch.zeros_like(a)
                     for a in alias]
            if dp is not None:
                dp.divide(grads)
        for a in alias:
            a.grad = None
        del alias, params
        if nmb > 1:
            for g in grads:
                g.div_(nmb)
            lsum = lsum / nmb
        if dp is None:
            gnorm = adamw.global_norm(grads)
        else:
            gnorm = dp.global_norm(grads)
            dp.mean([lsum])

        with span("train/optimizer"):
            new_p, new_opt, metrics = adamw.update(
                opt_cfg, rebuild(grads), state["opt"], state["params"],
                donate=True, gnorm=gnorm)
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": lsum, **metrics}

    return train_step


def _serving(shardings):
    """The tensor-parallel context of a serving step on the mesh of
    `shardings` (the params' `NamedSharding` tree), or None without."""
    if shardings is None:
        return None
    return TensorParallel(leaves(shardings)[0].mesh, shardings)


def make_prefill(model: Model, shardings=None, max_len: int | None = None):
    """The prefill `(params, batch) -> (last-token logits, caches)`, with
    `max_len` slots of KV cache (default: the prompt's).  `shardings`: the
    params' `NamedSharding` tree on a mesh (the reference's
    `jax.jit(prefill, in_shardings=...)`): `params` are then this rank's
    blocks, the step runs forward only under the tensor-parallel context
    it installs, and it returns this rank's rows and cache blocks
    (`Model.prefill`)."""
    tp = _serving(shardings)

    def prefill(params, batch):
        if tp is None:
            return model.prefill(params, batch, max_len)
        with torch.no_grad(), hooks.tensor_parallel_scope(tp):
            return model.prefill(params, batch, max_len)
    return prefill


def make_decode_step(model: Model, shardings=None, cache_shardings=None):
    """The decode step `(params, caches, tokens) -> (logits, caches)`.
    `shardings` and `cache_shardings`: the params' and the caches'
    `NamedSharding` trees on a mesh (`Model.cache_shardings`): `params`
    and `caches` are then this rank's blocks, as `make_prefill` returns
    them, and the step runs as the sharded prefill does."""
    tp = _serving(shardings)

    def decode_step(params, caches, tokens):
        if tp is None:
            return model.decode_step(params, caches, tokens)
        with torch.no_grad(), hooks.tensor_parallel_scope(tp):
            return model.decode_step(params, caches, tokens,
                                     cache_shardings=cache_shardings)
    return decode_step
