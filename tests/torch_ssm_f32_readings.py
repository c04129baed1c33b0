"""Where float32 parts the SSM smokes' train states from JAX's: the
readings behind the `quanta` of tests/test_torch_lm_tensor_parallel.py and
tests/test_torch_lm_ssm_parallel.py.  Not a test: run it as

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m tests.torch_ssm_f32_readings

(about ten minutes on one CPU core a rank).

  * For each case of tests/test_torch_lm_ssm_parallel.py, three steps: the
    sharded port's state against JAX's (as the test reads it), and each
    (and the port's one-rank float32 step) against a float64 step (the port's one-rank step with params, compute
    and moments in float64 and `Tensor.float` widened to float64: every
    float32 cast of the port's is then a float64 one).  A leaf is printed
    where its gap to JAX's passes 0.3 of its plain bound; the gap to JAX's
    can be as large as the two gaps to float64 together.
  * For the rwkv6 fallback (2 heads of 32), step 3 from JAX's state after
    step 2: JAX's float32 step, the port's one-rank float32 step, and that
    step with one function of `ssm.py` (or `_proj`, its projections)
    computed in float64, each against the float64 step, over the leaves
    where the gap is largest.
"""
import contextlib
import functools
import tempfile
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.models import make_train_step as jmake_train_step
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from tests.test_torch_lm_models import leaves, smoke
from tests.test_torch_lm_sharding import OPT, TOL_TREE_STEPS
from tests.test_torch_lm_ssm_parallel import CASES
from tests.test_torch_lm_tensor_parallel import RUN, STEPS, _jax_steps
from tests.test_torch_lm_train import TOL_LEAF, _tree_of
from tests.test_torch_sharding_ranks import float_as_double, spawn_ranks

LEAVES = ("/opt/v/embed/table", "/opt/m/embed/table",
          "/params/slots/0/tm/lora_B", "/opt/v/slots/0/tm/wk")


def _cast(x, dtype):
    if isinstance(x, dict):
        return {k: _cast(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def _wide(fn):
    """`fn` computed in float64 (its float inputs widened, `Tensor.float`
    a float64 cast) and its float outputs narrowed to float32."""
    @functools.wraps(fn)
    def wide(*args, **kw):
        with float_as_double():
            out = fn(*_cast(args, torch.float64), **kw)
        return _cast(out, torch.float32)
    return wide


def port_steps(arch, kw, state, batches, dtype="float32", wide=()):
    """The port's one-rank steps from `state` (numpy) on `batches` in
    `dtype`, with the functions `wide` names ((module, name)) in float64;
    the states after each step, as {path: numpy}."""
    from repro_torch import convert
    from repro_torch.configs import RunConfig
    from repro_torch.models import build_model, make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_map

    f64 = dtype == "float64"
    cfg = smoke(arch, dtype, **dict(kw, **({"param_dtype": dtype} if f64
                                         else {})))
    run = RunConfig(**RUN, **({"moment_dtype": dtype} if f64 else {}))
    st = _cast(convert.lm_tree_from_numpy(state, "cpu"),
               torch.float64 if f64 else torch.float32)
    step = make_train_step(build_model(cfg, run), AdamWConfig(**OPT))
    saved = {(m, n): getattr(m, n) for m, n in wide}
    out = []
    try:
        for (m, n), fn in saved.items():
            setattr(m, n, _wide(fn))
        with float_as_double() if f64 else contextlib.nullcontext():
            for b in batches:
                st, _ = step(st, convert.lm_tree_from_numpy(b, "cpu"))
                out.append(dict(leaves(tree_map(
                    lambda x: x.numpy().copy(), st))))
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)
    return out


def _gap(a, b, scale) -> float:
    return float(np.abs(a.astype(np.float64) - b).max() / scale)


def cases() -> None:
    want = {(a, kw): _jax_steps(a, kw) for _, a, _, kw in CASES}
    runs = {n: (a, dict(kw), "float32", RUN, {"data": d, "model": m},
                want[a, kw][0], want[a, kw][1])
            for n, a, (d, m), kw in CASES}
    out = spawn_ranks(4, [("mesh", "lm_mesh_steps", dict(runs=runs,
                                                         opt=OPT))],
                      Path(tempfile.mkdtemp()))
    for name, arch, _, kw in CASES:
        init, batches, _, states = want[arch, kw]
        true = port_steps(arch, kw, init, batches, "float64")
        one = port_steps(arch, kw, init, batches)
        for k in range(STEPS):
            jax_ = dict(leaves(states[k]))
            got = {p: t.detach().numpy()
                   for p, t in leaves(out[0]["mesh"][name]["states"][k])}
            trees: dict = {}
            for p, a in jax_.items():
                if a.dtype.kind == "f":
                    trees[_tree_of(p)] = max(trees.get(_tree_of(p), 0.0),
                                             float(np.abs(a).max()))
            for p, a in jax_.items():
                scale = float(np.abs(a).max()) if a.dtype.kind == "f" else 0
                if not scale:
                    continue
                bound = max(TOL_LEAF, TOL_TREE_STEPS * trees[_tree_of(p)]
                            / scale)
                gap = _gap(a, got[p], scale)
                if gap > 0.3 * bound:
                    print(f"{name} step {k + 1} {p}: from JAX's {gap:.3g} "
                          f"(plain bound {bound:.3g}); from float64: JAX's "
                          f"{_gap(a, true[k][p], scale):.3g}, the port's "
                          f"{_gap(got[p], true[k][p], scale):.3g} (its one "
                          f"rank's {_gap(one[k][p], true[k][p], scale):.3g})",
                          flush=True)


def fallback_step3() -> None:
    from repro_torch.models import ssm

    arch, kw = "rwkv6-7b", (("ssm_head_dim", 32),)
    _, batches, _, states = _jax_steps(arch, kw)
    cfg = smoke(arch, "float32", **dict(kw))
    jstep = jax.jit(jmake_train_step(jbuild_model(cfg, JRunConfig(**RUN)),
                                     JAdamWConfig(**OPT)))
    jax_ = dict(leaves(jax.tree_util.tree_map(
        np.asarray, jstep(states[1], batches[2])[0])))
    true = port_steps(arch, kw, states[1], batches[2:], "float64")[0]

    def line(tag, got):
        gaps = [f"{p} {_gap(got[p], true[p], np.abs(true[p]).max()):.3g}"
                for p in LEAVES]
        print(f"rwkv6 fallback step 3 from JAX's step-2 state, {tag}: "
              f"{', '.join(gaps)}", flush=True)

    line("JAX float32", jax_)
    line("the port float32", port_steps(arch, kw, states[1], batches[2:])[0])
    for mod, fn in ((ssm, "rwkv6_time_mix"), (ssm, "_proj"),
                    (ssm, "_rwkv_groupnorm"), (ssm, "_rwkv_decay"),
                    (ssm, "_rwkv_mix"), (ssm, "rwkv6_channel_mix")):
        line(f"the port float32, {fn} in float64", port_steps(
            arch, kw, states[1], batches[2:], wide=[(mod, fn)])[0])


if __name__ == "__main__":
    cases()
    fallback_step3()
