"""SSM heads over "model" in the LM's sharded program on gloo ranks: the
float64 steps, the gathers over "model" and one mixer's gradient
(repro_torch's `ssm.py` on "model" blocks), beside
tests/test_torch_lm_ssm_parallel.py's float32 steps against JAX.

  * In float64 (params, compute and every float32 cast of the port's) the
    sharded train step on four ranks is the one-rank step within TOL_F64
    of every leaf's scale: rwkv6-smoke on (2, 2) and zamba2-smoke on
    (1, 4).  The float32 gaps of the steps file are the sums' order.
  * Which leaves a rank gathers over "model" (a train step, a prefill and
    a decode step on (1, 4), every all-gather over "model" recorded): of
    the mixers' leaves only `in_proj`, `conv_w` and `conv_b`'s blocks where
    the heads divide, all of them in the fallback.
  * One mixer's gradient on two ranks, (1, 2), float32, against `jax.grad`
    of the reference's mixer: RWKV6's time mix and channel mix and Mamba2
    as the port runs them, and two traps that must fail: Mamba2's
    `in_proj` and conv gathered with `gather_from` (its backward keeps this
    rank's slice of its own partial gradient: the other ranks' terms of
    the B and C columns and of this rank's block are lost) and the
    RMSNorm's mean square summed with `reduce_from` (identity backward:
    each rank's gradient of the sum covers only its columns).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lm_models import leaves as path_leaves
from tests.test_torch_lm_models import smoke
from tests.test_torch_lm_ssm_parallel import (RWKV, RWKV_2HEADS, ZAMBA,
                                              ZAMBA_2HEADS)
from tests.test_torch_sharding_ranks import spawn_ranks

#: the float64 cases: (name, arch, mesh), each mixer, on each mesh
F64_CASES = (("rwkv6-2x2", RWKV, (2, 2)), ("zamba2-1x4", ZAMBA, (1, 4)))
#: the gather record's runs: (name, arch, config overrides), on (1, 4)
GATHERS = (("rwkv6", RWKV, ()), ("zamba2", ZAMBA, ()),
           ("rwkv6-2heads", RWKV, RWKV_2HEADS),
           ("zamba2-2heads", ZAMBA, ZAMBA_2HEADS))
#: the gradient cases on (1, 2): (name, arch, mixer, trap)
GRAD_CASES = (("rwkv6-tm", RWKV, "tm", None),
              ("rwkv6-cm", RWKV, "cm", None),
              ("mamba2", ZAMBA, "mamba", None),
              ("mamba2-gather_from", ZAMBA, "mamba", "gather_from"),
              ("mamba2-reduce_from", ZAMBA, "mamba", "reduce_from"))
#: the float64 steps' bound, of a leaf's scale
TOL_F64 = 1e-8
TOL_GRAD = 1e-5     # of a leaf's scale: one layer, float32
#: the least gap of its scale that a trap's wrong gradient shows
TRAP_GAP = 1e-2


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    gathers = {name: (arch, dict(kw), {"data": 1, "model": 4})
               for name, arch, kw in GATHERS}
    f64 = {name: (arch, {}, {"data": d, "model": m})
           for name, arch, (d, m) in F64_CASES}
    return spawn_ranks(4, [("gathers", "ssm_gathers", dict(runs=gathers)),
                           ("f64", "lm_mesh_f64", dict(runs=f64))],
                       tmp_path_factory.mktemp("ssm_units"))


@pytest.mark.parametrize("name", [c[0] for c in F64_CASES])
def test_sharded_steps_are_the_one_rank_step_in_float64(mesh_runs, name):
    """In float64 (params, compute and every float32 cast of the port) the
    sharded steps on a rank's heads are the one-rank steps to TOL_F64 of
    each leaf's scale and the losses to 1e-12: the split computes the same
    function, and the float32 gaps of the steps file are the sums' order."""
    for r in mesh_runs:
        for one, sharded, gap in r["f64"][name]:
            assert abs(one - sharded) <= 1e-12 * abs(one)
            assert gap <= TOL_F64, gap


def _mixer_blocks(arch, kw, m: int) -> dict:
    """{the shape of a mixer leaf's "model" block (a layer's, as the
    mixer reads it): its name} on a (1, m) mesh."""
    import types

    from repro_torch.distributed.sharding import spec_for
    from repro_torch.models import build_model, params_specs

    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": m})
    specs, axes = params_specs(build_model(smoke(arch, "float32", **dict(kw))))
    slot = specs["slots"][0]
    out = {}
    for sub in ("tm", "cm", "mixer"):
        for key, p in slot.get(sub, {}).items():
            logical = axes["slots"][0][sub][key]
            spec = tuple(spec_for(mesh, logical, tuple(p.shape)))
            if "model" in spec:
                shape = list(p.shape)
                shape[spec.index("model")] //= m
                out[tuple(shape[1:])] = f"{sub}/{key}"
    return out


@pytest.mark.parametrize("name,arch,kw", GATHERS, ids=[g[0] for g in GATHERS])
def test_only_in_proj_and_conv_are_gathered_over_model(mesh_runs, name, arch,
                                                       kw):
    """Every all-gather over "model" of a tensor of two dims or fewer (the
    params' blocks; activations have three) is of `in_proj`, `conv_w` or
    `conv_b`'s block, once a Mamba2 layer a forward, where the heads divide
    over "model"; in the fallback (2 heads on 4 ranks) every mixer leaf
    that the spec splits over "model" is gathered whole."""
    blocks = _mixer_blocks(arch, kw, 4)
    fallback = bool(kw)
    for r in mesh_runs:
        rec = r["gathers"][name]
        for kind in ("train", "serve"):
            params = [blocks.get(shape, shape) for shape, _ in rec[kind]
                      if len(shape) <= 2]
            if fallback:
                assert set(params) == set(blocks.values()), (kind, params)
            elif arch == ZAMBA:
                assert set(params) == {"mixer/in_proj", "mixer/conv_w",
                                       "mixer/conv_b"}, (kind, params)
            else:
                assert params == [], (kind, params)


@functools.lru_cache(maxsize=None)
def _jax_mixer_grad(arch, mixer):
    """One mixer of the smoke config at float32 (JAX's params, a random
    state, x and an upstream gradient drawn from a seed): (params, state,
    x, g, y, new state, d params, d x), as numpy."""
    from repro.models import ssm as jssm

    cfg = smoke(arch, "float32")
    init = {"tm": jssm.init_rwkv6_time_mix, "cm": jssm.init_rwkv6_channel_mix,
            "mamba": jssm.init_mamba2}[mixer]
    fn = {"tm": jssm.rwkv6_time_mix, "cm": jssm.rwkv6_channel_mix,
          "mamba": jssm.mamba2}[mixer]
    params, _ = init(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(7)
    # non-zero leaves where the init is constant, so that every term moves
    params = {k: jnp.asarray(rng.normal(size=v.shape) * 0.3, v.dtype)
              if k in ("maa_x", "maa_rkvwg", "lora_B", "w_lora_B", "u",
                       "maa_k", "maa_r", "conv_b", "dt_bias", "A_log")
              else v for k, v in params.items()}
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    whole = (jssm.init_rwkv6_state(cfg, 2) if mixer != "mamba"
             else jssm.init_mamba2_state(cfg, 2))
    state = whole[mixer] if mixer != "mamba" else whole
    state = {k: jnp.asarray(rng.normal(size=v.shape), v.dtype)
             for k, v in state.items()}

    def loss(p, x):
        return jnp.sum(fn(p, cfg, x, state)[0] * g)

    y, new = jax.jit(lambda p, x: fn(p, cfg, x, state))(params,
                                                        jnp.asarray(x))
    dp, dx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    np_ = functools.partial(jax.tree.map, np.asarray)
    return (np_(params), np_(state), x, g, np.asarray(y), np_(new), np_(dp),
            np.asarray(dx))


@pytest.fixture(scope="module")
def grads(tmp_path_factory):
    cases = {name: (arch, {}, {"data": 1, "model": 2}, mixer,
                    *_jax_mixer_grad(arch, mixer)[:4], trap)
             for name, arch, mixer, trap in GRAD_CASES}
    return spawn_ranks(2, [("grad", "ssm_grad", dict(cases=cases))],
                       tmp_path_factory.mktemp("ssm_grad"))


def _gap(want, got) -> float:
    a = np.asarray(want, dtype=np.float64)
    b = got.detach().double().numpy()
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("name,arch,mixer,trap", GRAD_CASES,
                         ids=[c[0] for c in GRAD_CASES])
def test_mixer_gradient_on_heads(grads, name, arch, mixer, trap):
    """Each rank's output, new state, x's gradient and every param's
    gradient (gathered from the blocks) against JAX's within TOL_GRAD of
    their scale, the mixer on the rank's heads; a trap's wrong collective
    gives a gradient at least TRAP_GAP of its scale off JAX's: `in_proj`'s
    with `gather_from`, x's with `reduce_from`."""
    _, _, _, _, y, new, dp, dx = _jax_mixer_grad(arch, mixer)
    heads = {"tm": "w0", "cm": "wr", "mamba": "A_log"}[mixer]
    for r in grads:
        got = r["grad"][name]
        assert got["split"][heads] is not None        # on the rank's heads
        assert _gap(y, got["y"]) <= TOL_GRAD, "y"
        for k, v in new.items():
            assert _gap(v.astype(np.float32), got["state"][k].float()) \
                <= (TOL_GRAD if v.dtype == np.float32 else 2 ** -8), k
        gaps = {path: _gap(want, dict(path_leaves(got["grads"]))[path])
                for path, want in path_leaves(dp)}
        gaps["x"] = _gap(dx, got["x_grad"])
        if trap is None:
            assert max(gaps.values()) <= TOL_GRAD, gaps
        else:
            wrong = "/in_proj" if trap == "gather_from" else "x"
            assert gaps[wrong] >= TRAP_GAP, gaps
    for r in grads[1:]:
        for (p, a), (_, b) in zip(path_leaves(grads[0]["grad"][name]["grads"]),
                                  path_leaves(r["grad"][name]["grads"])):
            assert torch.equal(a, b), p


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch,kw", [(RWKV, ()), (ZAMBA, ()),
                                     (RWKV, RWKV_2HEADS),
                                     (ZAMBA, ZAMBA_2HEADS)])
def test_whole_subtrees_only_where_heads_do_not_divide(arch, kw, mesh):
    """`model.whole_subtrees` names the fallback: an SSM slot's mixers where
    its heads do not divide over "model", nothing elsewhere."""
    from repro_torch.models import block_pattern
    from repro_torch.models.model import whole_subtrees
    from repro_torch.models.ssm import n_heads

    cfg = smoke(arch, "float32", **dict(kw))
    m = mesh[1]
    for slot in block_pattern(cfg)[0]:
        got = whole_subtrees(cfg, slot, m)
        divides = n_heads(cfg, slot) % m == 0
        assert bool(got) == (not divides), (slot, got)
        assert bool(got) == (bool(kw) and m == 4)
