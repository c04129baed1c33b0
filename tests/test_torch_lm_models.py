"""The port's LM serving path (repro_torch.models) against the JAX reference
at float32 compute.

For all ten `ARCH_IDS` at their smoke configs with compute dtype float32,
JAX's params and tokens carried across (`convert.lm_tree_from_numpy`; the
draws cannot match): the prefill's last-token logits, every cache leaf,
and four teacher-forced decode steps (each step from JAX's caches and
JAX's next token) with their logits and caches.  float32 leaves within
max |port - JAX| <= 1e-4 max |JAX|, bfloat16 leaves within one bfloat16 ulp
of the leaf's largest value (2^(e - 7) for a largest value in
[2^e, 2^(e + 1)), between 2^-8 and 2^-7 of it), int leaves (`pos`,
`slot_pos`) exactly.  Each step starts from JAX's caches because a bf16
cache entry that rounds the other way (a 1e-7 float32 difference can flip
it) moves the next step's logits by ~1e-3 of their scale: the step is held
as a function, and the port's own chain of steps against its own prefill
(the reference's 5e-2; `test_decode_matches_prefill` in
tests/test_torch_lm_configs.py).  At float32 the port's MoE routing equals
JAX's exactly.

The helpers here (`run_pair`, `assert_tree_close`) serve
tests/test_torch_lm_bf16.py and tests/test_torch_lm_paths.py too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, RunConfig, get_smoke_config
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro.models import hooks as jhooks
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.models import build_model, hooks

T, K, B = 10, 4, 2          # prompt, teacher-forced decode steps, batch
TOL_F32 = 1e-4              # max |port - JAX| / max |JAX|, float32 leaves


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def to_port(tree):
    return lm_tree_from_numpy(to_numpy(tree), "cpu")


def leaves(tree, path=""):
    """(path, leaf) over nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _as64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def assert_tree_close(want, got, tag=""):
    """JAX's tree (arrays) against the port's (tensors): the same keys,
    shapes and dtypes; float32 within TOL_F32 of the leaf's scale, bf16
    within one ulp of it, ints exactly."""
    w, g = dict(leaves(to_numpy(want))), dict(leaves(got))
    assert w.keys() == g.keys(), (tag, sorted(w.keys() ^ g.keys()))
    for path, a in w.items():
        b = g[path]
        where = f"{tag}{path}"
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, (
            where, a.dtype, b.dtype)
        assert tuple(b.shape) == a.shape, (where, a.shape, tuple(b.shape))
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=where)
            continue
        a64, b64 = _as64(a), _as64(b)
        scale = np.abs(a64).max()
        err = np.abs(a64 - b64).max()
        if a.dtype.name == "bfloat16":
            assert err <= bf16_ulp(scale), (where, err, bf16_ulp(scale))
        else:
            assert err <= TOL_F32 * scale, (where, err / scale, TOL_F32)


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x: 2^(e - 7) for x in [2^e, 2^(e + 1)),
    between 2^-8 and 2^-7 of x (0 at x = 0)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def rel_gap(want, got) -> float:
    a, b = _as64(want), _as64(got)
    return float(np.abs(a - b).max() / np.abs(a).max())


def smoke(arch: str, compute_dtype: str, **kw):
    cfg = dataclasses.replace(get_smoke_config(arch),
                              compute_dtype=compute_dtype, **kw)
    if cfg.num_experts:
        # no capacity drops, as tests/test_models_smoke.py's consistency
        # case (prefill drops overflow tokens, a decode step never does)
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    return cfg


def run_pair(cfg, *, run=None, eager=False, prompt=T, steps=K,
             max_len=None, routing=False):
    """JAX's and the port's prefill over `prompt` tokens with headroom
    `max_len` (default prompt + steps), then `steps` decode steps, each from
    JAX's caches and the next token.  With `routing`, JAX's MoE routing is
    recorded through its hook and injected into the port's.  Returns
    {"jax": [(logits, caches)...], "port": [...]}; entry 0 is the prefill."""
    run = run or RunConfig(remat="none", scan_layers=not eager)
    jm, tm = jbuild_model(cfg, run), build_model(cfg, run)
    params, _ = jm.init_params(jax.random.PRNGKey(2))
    tparams = to_port(params)
    full = jbatch_for(cfg, ShapeConfig("p", "prefill", prompt + steps, B))
    head = {**full, "tokens": full["tokens"][:, :prompt]}
    max_len = max_len or prompt + steps

    def jprefill(p, b):
        return jm.prefill(p, b, max_len=max_len)

    jdecode = jm.decode_step
    if not eager:
        jprefill, jdecode = jax.jit(jprefill), jax.jit(jdecode)
    recorded = []

    def record(x, tag):
        if tag == "moe_dispatch":
            recorded.append(np.asarray(x))
        return x

    def inject(x, tag):
        if tag != "moe_dispatch":
            return x
        return lm_tree_from_numpy(recorded.pop(0), "cpu")

    out = {"jax": [], "port": []}
    try:
        jc = None
        for i in range(steps + 1):
            tok = full["tokens"][:, prompt + i - 1][:, None]
            if routing:
                jhooks.set_activation_constraint(record)
            if i == 0:
                jl, jc_new = jprefill(params, head)
            else:
                jl, jc_new = jdecode(params, jc, tok)
            jhooks.set_activation_constraint(None)
            if routing:
                hooks.set_activation_constraint(inject)
            if i == 0:
                tl, tc = tm.prefill(tparams, to_port(head), max_len=max_len)
            else:
                tl, tc = tm.decode_step(tparams, to_port(jc), to_port(tok))
            hooks.set_activation_constraint(None)
            assert not recorded, "the port routed fewer times than JAX"
            out["jax"].append((to_numpy(jl), to_numpy(jc_new)))
            out["port"].append((tl, tc))
            jc = jc_new
    finally:
        jhooks.set_activation_constraint(None)
        hooks.set_activation_constraint(None)
    return out


# -- all ten archs at float32 compute ------------------------------------------


@pytest.fixture(scope="module", params=ARCH_IDS)
def f32_run(request):
    return request.param, run_pair(smoke(request.param, "float32"))


def test_prefill_logits_match_jax_f32(f32_run):
    arch, out = f32_run
    assert_tree_close(out["jax"][0][0], out["port"][0][0], f"{arch} logits")


def test_prefill_caches_match_jax_f32(f32_run):
    arch, out = f32_run
    assert_tree_close(out["jax"][0][1], out["port"][0][1], f"{arch} caches")


def test_decode_steps_match_jax_f32(f32_run):
    arch, out = f32_run
    for i in range(1, K + 1):
        (jl, jc), (tl, tc) = out["jax"][i], out["port"][i]
        assert_tree_close(jl, tl, f"{arch} step {i} logits")
        assert_tree_close(jc, tc, f"{arch} step {i} caches")
