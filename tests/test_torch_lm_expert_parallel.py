"""Expert parallelism and the split vision cross-attention in the LM train
step's sharded program on four gloo ranks (repro_torch's `moe_ffn` and
the cross-attention on "model" blocks) against JAX.

  * Train steps, three each, from JAX's state with JAX's batches against
    JAX's jitted unsharded steps, at tests/test_torch_lm_tensor_parallel.py's
    bounds (losses at rtol 1e-5, the whole state gathered after every step
    within 1e-4 of a leaf's scale or 3e-5 of its tree's), the ranks' losses
    and norms bit-identical:
      - llama4-smoke (8 experts top-1, a shared expert) on (2, 2) and
        (1, 4): each rank holds 4 or 2 experts and the shared expert's
        block of hidden units, one all-reduce over "model" sums both, the
        router is split over "model" and gathered whole;
      - grok-smoke with 2 experts on (1, 4): every expert's block of 32 of
        its 128 hidden units a rank, the router whole on "model";
      - the vision smoke on (2, 2): the cross-attention's q, k and v on
        this rank's heads, its wo row-parallel.  Its batches' vision
        embeddings are cast to float32 in both packages, so that the K and
        V projections run at the compute dtype: at bf16 each rank's rows'
        partial K/V weight gradient is a bf16 product rounded before the
        FSDP sum (1.07 bf16 ulps of its scale from the one rank's at the
        first step, which rounds once), and AdamW carries that into the
        next step's float32 leaves (2.1e-4 of a leaf's scale at step 2).
        On the card phase lm_train_mesh steps it with bf16 embeddings.
  * The router's gradient (one MoE layer, float32): under expert
    parallelism each rank back-propagates only its experts' terms, so the
    router's gradient is partial on each rank and must be summed over
    "model" (the router's gather reduce-scatters its gradient; a router
    whole on "model" is summed by `copy_to`).  Each rank's output, x's
    gradient and every param's gradient, gathered from the blocks, against
    `jax.grad` of the reference's `moe_ffn`: a gather that kept this
    rank's slice of its own partial gradient (`gather_from`'s backward)
    gives a router gradient off by the other ranks' terms.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lm_models import leaves as path_leaves
from tests.test_torch_lm_models import smoke
from tests.test_torch_lm_sharding import OPT, TOL_TREE_STEPS
from tests.test_torch_lm_tensor_parallel import RUN, STEPS, _jax_steps
from tests.test_torch_lm_train import BF16_GRADS, assert_leaves_close
from tests.test_torch_sharding_ranks import spawn_ranks

#: (name, arch, mesh, config overrides)
CASES = (("llama4-2x2", "llama4-maverick-400b-a17b", (2, 2), ()),
         ("llama4-1x4", "llama4-maverick-400b-a17b", (1, 4), ()),
         ("grok-2experts-1x4", "grok-1-314b", (1, 4),
          (("num_experts", 2),)),
         ("vision-2x2", "llama-3.2-vision-90b", (2, 2), ()))
IDS = [c[0] for c in CASES]
#: the router cases: (name, arch, mesh, config overrides, the "model"
#: split dim of the router, the experts and the shared expert's wi_gate
#: as the layer reads them)
GRAD_CASES = (("grok-2x2", "grok-1-314b", (2, 2), (), (1, 0, None)),
              ("grok-2experts-1x4", "grok-1-314b", (1, 4),
               (("num_experts", 2),), (None, 2, None)))
TOL_GRAD = 1e-5     # of a leaf's scale: one layer, float32


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    want = {(arch, kw): _jax_steps(arch, kw, embeds_f32=arch in BF16_GRADS)
            for arch, kw in {(a, kw) for _, a, _, kw in CASES}}
    runs = {name: (arch, dict(kw), "float32", RUN, {"data": d, "model": m},
                   want[arch, kw][0], want[arch, kw][1])
            for name, arch, (d, m), kw in CASES}
    grads = {name: (arch, dict(kw), {"data": d, "model": m},
                    *_jax_moe_grad(arch, kw)[:3])
             for name, arch, (d, m), kw, _ in GRAD_CASES}
    out = spawn_ranks(4, [("mesh", "lm_mesh_steps", dict(runs=runs, opt=OPT)),
                          ("grad", "moe_grad", dict(cases=grads))],
                      tmp_path_factory.mktemp("ep"))
    return want, out


@pytest.mark.parametrize("name,arch,mesh,kw", CASES, ids=IDS)
def test_sharded_steps_match_jax(mesh_runs, name, arch, mesh, kw):
    want, out = mesh_runs
    _, _, losses, states = want[arch, kw]
    got = [r["mesh"][name] for r in out]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]          # bit-identical
        assert r["norms"] == got[0]["norms"]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for k in range(STEPS):
        assert_leaves_close(states[k], got[0]["states"][k],
                            f"{name} step {k + 1} ",
                            tol_tree=TOL_TREE_STEPS)
    for r in got[1:]:
        for (p, a), (_, b) in zip(path_leaves(got[0]["states"][-1]),
                                  path_leaves(r["states"][-1])):
            assert torch.equal(a, b), p


@functools.lru_cache(maxsize=None)
def _jax_moe_grad(arch, kw):
    """One MoE layer of the smoke config at float32 (JAX's params, x and an
    upstream gradient drawn from a seed): (params, x, g, y, d params,
    d x), as numpy."""
    from repro.models.moe import init_moe, moe_ffn

    cfg = smoke(arch, "float32", **dict(kw))
    params, _ = init_moe(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 6, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def loss(p, x):
        return jnp.sum(moe_ffn(p, cfg, x) * g)

    y = moe_ffn(params, cfg, jnp.asarray(x))
    dp, dx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return (jax.tree.map(np.asarray, params), x, g, np.asarray(y),
            jax.tree.map(np.asarray, dp), np.asarray(dx))


def _close(want, got, tag):
    a = np.asarray(want, dtype=np.float64)
    b = got.detach().double().numpy()
    assert a.shape == b.shape, tag
    err, scale = np.abs(a - b).max(), np.abs(a).max()
    assert err <= TOL_GRAD * scale, (tag, err / scale)


@pytest.mark.parametrize("name,arch,mesh,kw,splits", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_router_gradient_is_summed_over_model(mesh_runs, name, arch, mesh,
                                              kw, splits):
    _, out = mesh_runs
    _, _, _, y, dp, dx = _jax_moe_grad(arch, kw)
    for r in out:
        got = r["grad"][name]
        split = got["split"]
        assert (split["router"], split["wi_gate"],
                split.get("shared", {}).get("wi_gate")) == splits
        _close(y, got["y"], f"{name} y")
        _close(dx, got["x_grad"], f"{name} dx")
        for path, want in path_leaves(dp):
            have = dict(path_leaves(got["grads"]))[path]
            _close(want, have, f"{name} d{path}")
    # every rank's gradients gathered alike, bit for bit
    for r in out[1:]:
        for (p, a), (_, b) in zip(path_leaves(out[0]["grad"][name]["grads"]),
                                  path_leaves(r["grad"][name]["grads"])):
            assert torch.equal(a, b), p


def test_cases_split_the_experts():
    """The specs the cases run on: llama4-smoke's 8 experts over "model"
    (expert parallelism), grok-smoke's 2 experts whole on a 4-way "model"
    axis with their hidden units split, the vision smoke's cross-attention
    heads over "model"."""
    import types

    from repro_torch.distributed.sharding import spec_for

    def spec(mesh, logical, shape):
        d, m = mesh
        return tuple(spec_for(types.SimpleNamespace(
            axis_names=("data", "model"), shape={"data": d, "model": m}),
            logical, shape))

    for name, arch, mesh, kw in CASES:
        cfg = dataclasses.replace(smoke(arch, "float32"), **dict(kw))
        if cfg.num_experts:
            E, D, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
            got = spec(mesh, ("experts", "embed", "mlp"), (E, D, Fd))
            if E % mesh[1] == 0:
                assert got[0] == "model" and got[2] is None, name
            else:
                assert got[0] is None and got[2] == "model", name
        else:
            H, hd, D = cfg.num_heads, cfg.head_dim, cfg.d_model
            assert spec(mesh, ("embed", "q_heads"), (D, H * hd))[1] \
                == "model"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,E,C", [(2, 37, 2, 8, 11), (3, 16, 1, 16, 3),
                                       (1, 64, 2, 4, 40)])
def test_dispatch_is_the_references_einsums(B, S, K, E, C, dtype):
    """`moe._dispatch_combine` (no (B,S,K,E,C) one-hot) against the
    reference's einsums over it, bit for bit, with and without capacity
    drops."""
    from repro_torch.models.moe import _dispatch_combine, _top_k

    rng = np.random.default_rng(B * S + C)
    gates = jax.nn.softmax(jnp.asarray(rng.normal(size=(B, S, E)),
                                       jnp.float32), axis=-1)
    topv, topi = jax.lax.top_k(gates, K)
    topv = topv / jnp.sum(topv, axis=-1, keepdims=True)
    oh = jax.nn.one_hot(topi, E, dtype=jnp.int32)
    flat = oh.reshape(B, S * K, E)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(B, S, K, E)
    keep = (pos >= 0) & (pos < C)
    jdt = getattr(jnp, dtype)
    pos_oh = jax.nn.one_hot(jnp.where(keep, pos, C), C + 1,
                            dtype=jdt)[..., :C]
    want_d = jnp.einsum("bske,bskec->bsec", oh.astype(jdt), pos_oh)
    want_c = jnp.einsum("bsk,bske,bskec->bsec", topv.astype(jdt),
                        oh.astype(jdt), pos_oh)
    tv, ti = _top_k(torch.tensor(np.asarray(gates)), K)
    assert torch.equal(ti, torch.tensor(np.asarray(topi)).long())
    tv = tv / tv.sum(dim=-1, keepdim=True)
    d, c = _dispatch_combine(tv, torch.tensor(np.asarray(oh)),
                             torch.tensor(np.asarray(pos)), C,
                             getattr(torch, dtype))
    for want, got in ((want_d, d), (want_c, c)):
        assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                              got.float().numpy())
