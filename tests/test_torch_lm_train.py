"""The port's training step (repro_torch.models.train, optim/) against the JAX
reference at float32 compute: the dense family here, MoE in
tests/test_torch_lm_train_moe.py, the mixers (RWKV6, Mamba2 hybrid, audio,
VLM) in tests/test_torch_lm_train_ssm.py and
tests/test_torch_lm_train_mixers.py, bf16 compute in
tests/test_torch_lm_train_bf16.py.

For each arch's smoke config (compute float32; MoE capacity_factor 8, as
tests/test_torch_lm_models.py), JAX's train state and batch carried across
(`convert.lm_tree_from_numpy`):

  * the gradients of `train_loss` alone against `jax.grad`'s;
  * one `make_train_step` step (microbatches 1 and 2; remat "full" and
    "none") against JAX's jitted step: loss and grad_norm within 1e-5, lr
    bit for bit, every updated param, m and v leaf, and `step` / `count`
    exactly.

A float leaf is held within 1e-4 of its own scale (max |JAX|) or within
1e-5 of its tree's scale (the whole gradient, the params, m or v: the
larger of the two).  The floor covers leaves far below their tree: a
zero-initialised bias after one step is lr times AdamW's direction
g / (|g| + eps), which turns the rounding of a near-zero gradient into up
to a few 1e-3 of the leaf (the key bias's gradient is small: after RoPE
the bias is a per-key term that softmax nearly ignores); an MoE router's
gradient is 3.2e-6 of the tree's, and JAX's own jit and op-by-op paths
part there by 5.5e-4 of its scale (`witness` below prints these gaps).
The cross-attention K and V projections of the vision family run
in bfloat16 at any compute dtype (the vision embeddings are bf16, in both
packages), so their gradients are held within one bf16 ulp of the leaf's
scale (on V JAX's jit and op-by-op part by 1.9e-3), and their m and v
after a step within two.

The step runs in the port's remat form (`torch.utils.checkpoint` around a
layer group) and without it: the two must agree bit for bit on the CPU.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro.models import init_train_state as jinit_train_state
from repro.models import make_train_step as jmake_train_step
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.configs import RunConfig
from repro_torch.models import build_model, make_train_step
from repro_torch.optim.adamw import AdamWConfig
from tests.test_torch_lm_models import bf16_ulp, leaves, smoke, to_numpy, to_port

SEQ, BATCH = 16, 4           # tests/test_models_smoke.py's sequence
OPT = dict(warmup_steps=2, total_steps=10)
TOL_LEAF = 1e-4              # of the leaf's scale
TOL_TREE = 1e-5              # of its tree's scale
TOL_SCALAR = 1e-5            # loss and grad_norm, relative
#: leaves computed in bfloat16 whatever the compute dtype (bf16 vision
#: embeddings projected to K and V by the cross-attention slot)
BF16_GRADS = {"llama-3.2-vision-90b": ("/slots/0/attn/wk",
                                       "/slots/0/attn/wv")}
DENSE = ("qwen2-7b", "yi-34b", "codeqwen1.5-7b", "nemotron-4-340b")


def _tree_of(path: str) -> str:
    parts = path.split("/")
    return "/".join(parts[:3]) if parts[1] == "opt" else "/".join(parts[:2])


def assert_leaves_close(want, got, tag="", bf16_leaves=(), quanta=None,
                        ulps=1, tol_tree=TOL_TREE):
    """JAX's tree (numpy) against the port's (tensors), by path: the same
    dtypes and shapes; ints exactly; floats within TOL_LEAF of the leaf's
    scale or `tol_tree` of its tree's, `bf16_leaves` within `ulps` bf16 ulps
    of the leaf's scale, and leaves under a prefix of `quanta` within that
    fraction of their scale.  Returns the largest gap of a leaf's scale."""
    w, g = dict(leaves(want)), dict(leaves(got))
    assert w.keys() == g.keys(), (tag, sorted(w.keys() ^ g.keys()))
    trees: dict = {}
    for path, a in w.items():
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            t = _tree_of(path)
            trees[t] = max(trees.get(t, 0.0),
                           float(np.abs(a.astype(np.float64)).max()))
    worst = 0.0
    for path, a in w.items():
        b = g[path]
        where = f"{tag}{path}"
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, where
        assert tuple(b.shape) == a.shape, where
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b.numpy(), a, err_msg=where)
            continue
        a64 = a.astype(np.float64)
        err = float(np.abs(a64 - b.detach().double().numpy()).max())
        scale = float(np.abs(a64).max())
        quantum = [f for pre, f in (quanta or {}).items()
                   if path.startswith(pre)]
        if any(path.endswith(s) for s in bf16_leaves):
            bound = ulps * bf16_ulp(scale)
        elif quantum:
            bound = quantum[0] * scale
        else:
            bound = max(TOL_LEAF * scale, tol_tree * trees[_tree_of(path)])
        assert err <= bound, (where, err, bound, scale)
        if scale > 0:
            worst = max(worst, err / scale)
    return worst


def jax_case(arch: str, nmb: int, compress: bool = False,
             moment_dtype: str = "float32"):
    """JAX's initial state and batch, its jitted step's new state and
    metrics, and (one microbatch, no compression) its gradients of
    `train_loss` alone (numpy); computed once a case in a process."""
    return _jax_case(arch, nmb, compress, moment_dtype)


@functools.lru_cache(maxsize=None)
def _jax_case(arch, nmb, compress, moment_dtype):
    cfg = smoke(arch, "float32")
    run = JRunConfig(num_microbatches=nmb, remat="full",
                     grad_compress=compress, moment_dtype=moment_dtype)
    jm = jbuild_model(cfg, run)
    state, _ = jinit_train_state(jm, jax.random.PRNGKey(3))
    batch = jbatch_for(cfg, ShapeConfig("t", "train", SEQ, BATCH))
    step = jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT)))
    new, metrics = step(state, batch)
    grads = None
    if nmb == 1 and not compress and moment_dtype == "float32":
        loss, grads = jax.jit(jax.value_and_grad(jm.train_loss))(
            state["params"], batch)
        grads = (float(loss), to_numpy(grads))
    return (cfg, to_numpy(state), to_numpy(batch), to_numpy(new),
            {k: float(v) for k, v in metrics.items()}, grads)


def port_step(arch, nmb, remat, compress=False, moment_dtype="float32"):
    cfg, state, batch, _, _, _ = jax_case(arch, nmb, compress, moment_dtype)
    run = RunConfig(num_microbatches=nmb, remat=remat,
                    grad_compress=compress, moment_dtype=moment_dtype)
    step = make_train_step(build_model(cfg, run), AdamWConfig(**OPT))
    return step(to_port(state), to_port(batch))


def check_step(arch, nmb, remat, quanta=None, **kw):
    _, _, _, want, jmet, _ = jax_case(arch, nmb, kw.get("compress", False),
                                      kw.get("moment_dtype", "float32"))
    new, met = port_step(arch, nmb, remat, **kw)
    for k in ("loss", "grad_norm"):
        assert abs(float(met[k]) - jmet[k]) <= TOL_SCALAR * abs(jmet[k]), (
            k, float(met[k]), jmet[k])
    assert float(met["lr"]) == jmet["lr"]
    assert int(new["step"]) == 1 and int(new["opt"]["count"]) == 1
    # a bf16-computed gradient's leaves: its m (0.1 g) within one ulp of
    # the leaf's scale, v (0.05 g^2) within two
    assert_leaves_close(want, new, f"{arch} nmb={nmb} remat={remat}",
                        bf16_leaves=BF16_GRADS.get(arch, ()), quanta=quanta,
                        ulps=2)
    return new, met


def check_grads(arch):
    cfg, state, batch, _, _, (jloss, jgrads) = jax_case(arch, 1)
    params = jax.tree.map(lambda t: t.requires_grad_(True),
                          to_port(state["params"]))
    loss = build_model(cfg, RunConfig(remat="full")).train_loss(
        params, to_port(batch))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= TOL_SCALAR * abs(jloss)
    got = jax.tree.map(lambda t: t.grad if t.grad is not None
                       else torch.zeros_like(t), params)
    assert_leaves_close(jgrads, got, f"{arch} grads",
                        bf16_leaves=BF16_GRADS.get(arch, ()))


@pytest.mark.parametrize("arch", DENSE)
def test_train_loss_grads_match_jax(arch):
    check_grads(arch)


@pytest.mark.parametrize("nmb", [1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_jax(arch, nmb):
    """One step, remat "full" (the launcher's) and "none", against JAX's
    jitted step; the two port runs bit for bit."""
    full, mfull = check_step(arch, nmb, "full")
    none, mnone = check_step(arch, nmb, "none")
    assert float(mfull["loss"]) == float(mnone["loss"])
    for (p, a), (_, b) in zip(leaves(full), leaves(none)):
        assert torch.equal(a, b), p


def test_train_step_grad_compress_matches_jax():
    """int8 error feedback over two microbatches (qwen2).  A gradient
    element that sits at a rounding boundary of its int8 grid (a 1e-7
    difference moves it across) comes out one quantum, max |g| / 127, away
    (measured: 1-2 elements of a few leaves), which moves m by up to 1/127
    of its scale and v by up to 2/127; every other leaf as without
    compression."""
    check_step("qwen2-7b", 2, "full", compress=True,
               quanta={"/opt/m/": 1 / 127, "/opt/v/": 2 / 127})


def test_bf16_moments_come_back_float32():
    """A state made with RunConfig(moment_dtype="bfloat16") under the
    default AdamWConfig (float32 moments): m and v are bfloat16 before the
    step and float32 after it, as the reference's (held against JAX's)."""
    cfg, state, *_ = jax_case("qwen2-7b", 1, moment_dtype="bfloat16")
    assert all(a.dtype.name == "bfloat16"
               for _, a in leaves(state["opt"]["m"]))
    new, _ = check_step("qwen2-7b", 1, "full", moment_dtype="bfloat16")
    assert all(t.dtype == torch.float32 for _, t in leaves(new["opt"]["m"]))


def test_train_step_updates_in_place():
    """The step writes into the state's own tensors (the reference's jitted
    step donates its state): the returned params, m and v are the input's
    tensors, and the three steps' losses match a fresh state's run."""
    cfg, state, batch, *_ = jax_case("qwen2-7b", 2)
    run = RunConfig(num_microbatches=2)
    step = make_train_step(build_model(cfg, run), AdamWConfig(**OPT))
    s = to_port(state)
    before = [t for _, t in leaves(s["params"])]
    for _ in range(3):
        s, _ = step(s, to_port(batch))
    assert all(a is b for a, b in zip(before,
                                      (t for _, t in leaves(s["params"]))))
    assert int(s["step"]) == 3 and s["step"].dtype == torch.int32


def test_train_specs_on_meta():
    """`params_specs` and `train_state_specs`: meta tensors of the params'
    and state's shapes and dtypes and the axes tree, drawn from nothing, at
    qwen2-7b's full config (7.6 B params, no allocation), equal to JAX's
    `eval_shape`."""
    from repro.configs import get_config as jget_config
    from repro.models import train_state_specs as jspecs
    from repro_torch.configs import get_config
    from repro_torch.models import params_specs, train_state_specs

    cfg = get_config("qwen2-7b")
    model = build_model(cfg, RunConfig())
    state, axes = train_state_specs(model)
    p, paxes = params_specs(model)
    jstate, jaxes = jspecs(jbuild_model(jget_config("qwen2-7b"),
                                        JRunConfig()))
    assert axes == paxes
    assert jax.tree.map(tuple, jaxes,
                        is_leaf=lambda x: isinstance(x, tuple)) == axes
    w, g = dict(leaves(jax.tree.map(lambda s: s, jstate))), dict(leaves(state))
    assert w.keys() == g.keys()
    for k, a in w.items():
        assert g[k].device.type == "meta", k
        assert tuple(g[k].shape) == a.shape, k
        assert str(g[k].dtype).removeprefix("torch.") == a.dtype.name, k
    assert all(t.device.type == "meta" for _, t in leaves(p))
    n = sum(t.numel() for _, t in leaves(p))
    assert 7.0e9 < n < 8.0e9, n
    assert dataclasses.is_dataclass(cfg)


def witness(arch: str) -> None:
    """Print, for `arch`'s gradients of `train_loss`, each leaf the port
    holds only by the tree floor or a bf16 ulp: its gap to JAX's jitted
    gradient as a share of its scale and of the tree's, its scale as a
    share of the tree's, and JAX's own gap, jit against op by op (the
    evidence for the bounds above)."""
    cfg, state, batch, _, _, (_, jgrads) = jax_case(arch, 1)
    jm = jbuild_model(cfg, JRunConfig(remat="none", scan_layers=False))
    _, eager = jax.value_and_grad(jm.train_loss)(
        jax.tree.map(jax.numpy.asarray, state["params"]),
        jax.tree.map(jax.numpy.asarray, batch))
    params = jax.tree.map(lambda t: t.requires_grad_(True),
                          to_port(state["params"]))
    build_model(cfg, RunConfig(remat="full")).train_loss(
        params, to_port(batch)).backward()
    want, mine = dict(leaves(jgrads)), dict(leaves(params))
    own = dict(leaves(to_numpy(eager)))
    top = max(np.abs(a).max() for a in want.values())
    for path, a in want.items():
        a64 = a.astype(np.float64)
        scale = np.abs(a64).max()
        gap = np.abs(a64 - mine[path].grad.double().numpy()).max()
        if scale > 0 and gap > TOL_LEAF * scale:
            jgap = np.abs(a64 - own[path]).max()
            print(f"{arch}{path}: port {gap / scale:.2e} of the leaf, "
                  f"{gap / top:.2e} of the tree; leaf/tree "
                  f"{scale / top:.2e}; JAX jit vs op by op "
                  f"{jgap / scale:.2e} of the leaf")


if __name__ == "__main__":
    # python -m tests.test_torch_lm_train [arch ...] (CPU, JAX_PLATFORMS=cpu)
    import sys
    for name in sys.argv[1:] or ("llama-3.2-vision-90b",
                                 "llama4-maverick-400b-a17b", "qwen2-7b"):
        witness(name)
