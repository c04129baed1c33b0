"""Expert parallelism and the split vision cross-attention in the LM's
sharded serving program (repro_torch's `make_prefill` and
`make_decode_step` with the shardings) on four gloo ranks against JAX's
jitted unsharded `prefill` and `decode_step`, at
tests/test_torch_lm_serve_mesh.py's bounds and with its helpers: the
prefill's last-token logits and caches, four teacher-forced decode steps
each from JAX's caches, every rank's gathered logits the same bits.

  * llama4-smoke (8 experts top-1 and a shared expert, 96 hidden units) on
    (2, 2) and (1, 4): each rank holds 4 or 2 experts and computes its
    experts' part of the MoE output and its block of the shared expert's,
    summed in one all-reduce over "model"; the router gathered whole;
  * grok-smoke with 2 experts on (1, 4): 2 experts do not divide over 4,
    so each rank holds every expert's block of 32 of its 128 hidden units;
  * the vision smoke (4 heads, 2 kv heads, 17 image tokens) on (2, 2) (the
    cross-attention's q, k and v on this rank's heads, its K/V cache on
    "kv_heads") and (1, 4) (q on the rank's head, k and v gathered over
    "model", the cross cache whole on "model");
  * the pooled decode routing: grok-smoke (4 experts top-2) at the
    reference's capacity factor 1.25 on (2, 2) with 4 rows, JAX's
    embedding shifted on one coordinate and each router's column 0 raised
    on it, so that every token of a decode step picks expert 0 (and one
    other): the reference pools the 4 rows into one routing row at
    capacity 3 and drops the fourth token's assignment.  A rank that
    pooled only its own 2 rows would route at capacity 2 and drop nothing
    (its first decode step's logits 0.57 of their scale off JAX's); the
    ranks route the global pool.
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_lm_models import smoke
from tests.test_torch_lm_serve_mesh import (K, _got, _jax_serve,
                                            assert_tree_close)
from tests.test_torch_sharding_ranks import spawn_ranks

POOL = (("capacity_factor", 1.25),)
#: name -> (arch, config overrides, compute, (data, model), batch,
#: max_len, the first KV cache's layout on "model"), as
#: tests/test_torch_lm_serve_mesh.py's CASES
CASES = {
    "llama4-2x2": ("llama4-maverick-400b-a17b", (), "float32", (2, 2), 4,
                   16, "kv_heads"),
    "llama4-1x4": ("llama4-maverick-400b-a17b", (), "float32", (1, 4), 4,
                   16, "kv_seq"),
    "grok-2experts-1x4": ("grok-1-314b", (("num_experts", 2),), "float32",
                          (1, 4), 4, 16, "kv_seq"),
    "vision-2x2": ("llama-3.2-vision-90b", (), "float32", (2, 2), 4, 16,
                   "kv_heads"),
    "vision-1x4": ("llama-3.2-vision-90b", (), "float32", (1, 4), 4, 16,
                   "kv_seq"),
    "grok-pool-2x2": ("grok-1-314b", POOL, "float32", (2, 2), 4, 16,
                    "kv_heads"),
}


def _every_token_to_expert_0(params):
    """JAX's params with a residual stream dominated by one coordinate
    (the embedding's column 0 shifted by 1) and each MoE router's column 0
    set to 20 on it: every token picks expert 0 at every layer."""
    params = dict(params, embed={"table": params["embed"]["table"]
                                 .at[:, 0].add(1.0)})
    slots = []
    for slot in params["slots"]:
        if "router" in slot.get("ffn", {}):
            r = slot["ffn"]["router"]
            slot = dict(slot, ffn=dict(slot["ffn"],
                                       router=r.at[:, 0, 0].set(20.0)))
        slots.append(slot)
    return dict(params, slots=slots)


def _cfg(arch, kw, compute):
    kw = dict(kw)
    cf = kw.pop("capacity_factor", None)
    cfg = smoke(arch, compute, **kw)
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    want, runs = {}, {}
    for name, (arch, kw, compute, (d, m), batch, max_len,
               _) in CASES.items():
        edit = _every_token_to_expert_0 if kw == POOL else None
        params, head, steps, outs = _jax_serve(
            _cfg(arch, kw, compute), batch, max_len, eager=False, edit=edit)
        want[name] = outs
        runs[name] = (arch, dict(kw), compute, {"data": d, "model": m},
                      params, head, max_len, steps)
    out = spawn_ranks(4, [("serve", "lm_serve_mesh", dict(runs=runs))],
                      tmp_path_factory.mktemp("ep_serve"))
    return want, out


@pytest.mark.parametrize("name", list(CASES))
def test_cache_layout(served, name):
    """The first KV cache's heads on "model" where KV divides, else its
    slots; its rows on the FSDP axis where the batch divides."""
    _, got = _got(served, name)
    layout, spec = CASES[name][-1], got["spec"]
    (d, m), batch = CASES[name][3], CASES[name][4]
    dims = {"kv_seq": 2, "kv_heads": 3}
    assert [i for i, e in enumerate(spec) if e == "model"] == [dims[layout]]
    assert (spec[1] == "data") == (batch % d == 0), spec


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(served, name):
    want, got = _got(served, name)
    (jl, jc), (tl, tc) = want[0], got["steps"][0]
    assert_tree_close(jl, tl, f"{name} prefill logits")
    assert_tree_close(jc, tc, f"{name} prefill caches")


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_jax(served, name):
    want, got = _got(served, name)
    for i in range(1, K + 1):
        (jl, jc), (tl, tc) = want[i], got["steps"][i]
        assert_tree_close(jl, tl, f"{name} step {i} logits")
        assert_tree_close(jc, tc, f"{name} step {i} caches")


def test_pool_case_drops_a_token_in_the_reference():
    """The pool case's input does what it is for: in JAX's first decode step
    every token of the 4-row pool picks expert 0, whose capacity is 3."""
    import jax

    from repro.configs import RunConfig
    from repro.configs.base import ShapeConfig
    from repro.data import batch_for
    from repro.models import build_model, hooks

    arch, kw, compute, _, batch, max_len, _ = CASES["grok-pool-2x2"]
    cfg = _cfg(arch, kw, compute)
    jm = build_model(cfg, RunConfig(remat="none", scan_layers=False))
    params, _ = jm.init_params(jax.random.PRNGKey(2))
    params = _every_token_to_expert_0(params)
    full = batch_for(cfg, ShapeConfig("p", "prefill", 11, batch))
    _, caches = jm.prefill(params, {**full, "tokens": full["tokens"][:, :10]},
                           max_len=max_len)
    seen = []
    hooks.set_activation_constraint(
        lambda x, tag: (seen.append(np.asarray(x)) if tag == "moe_dispatch"
                        else None) or x)
    try:
        jm.decode_step(params, caches, full["tokens"][:, 10:11])
    finally:
        hooks.set_activation_constraint(None)
    dispatch = seen[0::2]                 # (1, B, E, C), then the combine
    assert len(dispatch) == cfg.num_layers
    for d in dispatch:
        assert d.shape == (1, batch, cfg.num_experts, 3)
        kept = d[0].sum(axis=(0, 2))
        assert kept[0] == 3 and kept.sum() < batch * cfg.experts_per_token


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_cross_cache_layout(mesh):
    """The vision cross-attention's K/V cache: its rows on the FSDP axis,
    its kv heads on "model" where they divide (2 on (2, 2)), else whole
    there (2 kv heads on (1, 4)); the RWKV6 state's heads (4) on "model"
    (a rank computes its heads) and its `x_prev` whole there."""
    import types

    from repro_torch.models import build_model

    d, m = mesh
    shape = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": d, "model": m})
    model = build_model(smoke("llama-3.2-vision-90b", "float32"))
    cross = model.cache_shardings(shape, 4, 16)["slots"][0]
    for key in ("k", "v"):
        spec = tuple(cross[key].spec)
        assert spec[1] == "data"
        assert spec[3] == ("model" if m == 2 else None), spec
    rwkv = build_model(smoke("rwkv6-7b", "float32")).cache_shardings(
        shape, 4, 16)["slots"][0]["tm"]
    assert tuple(rwkv["wkv"].spec)[2] == "model", rwkv["wkv"].spec
    assert "model" not in tuple(rwkv["x_prev"].spec), rwkv["x_prev"].spec
