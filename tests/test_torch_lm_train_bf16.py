"""The gradients of `train_loss` at the configs' own bf16 compute, the port
against JAX, at the smoke configs: the dense and MoE archs here, the rest
in tests/test_torch_lm_train_bf16_mixers.py.

bf16 rounds at every op, and the backward adds as many roundings again, so
the two packages part by far more than at float32 (held there at 1e-4 of
each leaf's scale, tests/test_torch_lm_train.py).  The bound here is
measured on the reference itself: JAX's gradients against JAX's with its
params scaled by 1 + 1e-3 N(0, 1) (the perturbation of
tests/test_torch_lm_bf16.py's routing study), in the same test.  The
port's largest gap (of the gradient tree's largest value) must stay within
twice JAX's own largest gap, and the port's median gap of a leaf's scale
within twice JAX's own median.  Measured on these inputs (`python -m
tests.test_torch_lm_train_bf16` prints them; gap of the tree's largest
value, port / JAX's own): 1.2e-2–4.1e-2 / 2.3e-2–5.3e-2 for
eight archs; zamba2 0.55 / 0.32; rwkv6 0.34 / 52 (its bf16 gradient is
ill-conditioned in the reference itself).  The loss is held within the
reference's 5e-2.

JAX runs jitted (its CPU backend keeps fused bf16 chains in float32, ROADMAP
Queue 3); MoE routing is the port's own: on these inputs the bound holds
without injecting JAX's routing through the `moe_dispatch` hook.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro_torch.configs import RunConfig
from repro_torch.models import build_model
from tests.test_torch_lm_models import leaves, smoke, to_numpy, to_port

LOSS_TOL = 5e-2         # tests/test_models_smoke.py's bf16 bound
SELF_FACTOR = 2.0       # of JAX's own gap under the 1e-3 perturbation
ARCHS = ("qwen2-7b", "yi-34b", "codeqwen1.5-7b", "nemotron-4-340b",
         "grok-1-314b", "llama4-maverick-400b-a17b")


def _gaps(want: dict, got: dict) -> tuple[float, float]:
    """(largest gap of the tree's largest value, median gap of a leaf's
    scale) of `got` against `want`."""
    top = max(np.abs(a.astype(np.float64)).max() for a in want.values())
    worst, rel = 0.0, []
    for k, a in want.items():
        a64 = a.astype(np.float64)
        err = np.abs(a64 - np.asarray(got[k], np.float64)).max()
        worst = max(worst, err / top)
        scale = np.abs(a64).max()
        if scale > 0:
            rel.append(err / scale)
    return worst, float(np.median(rel))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_bf16_within_jax_own_spread(arch):
    check_bf16_grads(arch)


def check_bf16_grads(arch):
    cfg = smoke(arch, "bfloat16")
    assert cfg.compute_dtype == "bfloat16"
    jm = jbuild_model(cfg, JRunConfig(remat="full"))
    params, _ = jm.init_params(jax.random.PRNGKey(3))
    batch = jbatch_for(cfg, ShapeConfig("t", "train", 16, 4))
    vg = jax.jit(jax.value_and_grad(jm.train_loss))
    jloss, jgrads = vg(params, batch)
    flat, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(11), len(flat))
    scaled = jax.tree.unflatten(tdef, [
        p * (1 + 1e-3 * jax.random.normal(k, p.shape)).astype(p.dtype)
        for p, k in zip(flat, keys)])
    _, sgrads = vg(scaled, batch)

    tparams = jax.tree.map(lambda t: t.requires_grad_(True),
                           to_port(params))
    loss = build_model(cfg, RunConfig(remat="full")).train_loss(
        tparams, to_port(batch))
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= LOSS_TOL
    want = dict(leaves(to_numpy(jgrads)))
    own = _gaps(want, dict(leaves(to_numpy(sgrads))))
    got = _gaps(want, {k: t.grad.double().numpy() if t.grad is not None
                       else np.zeros(t.shape) for k, t in leaves(tparams)})
    assert got[0] <= SELF_FACTOR * own[0], (arch, got, own)
    assert got[1] <= SELF_FACTOR * own[1], (arch, got, own)
    assert all(bool(torch.isfinite(t.grad).all()) for _, t in leaves(tparams)
               if t.grad is not None)
    return got, own


if __name__ == "__main__":
    # python -m tests.test_torch_lm_train_bf16 (CPU, JAX_PLATFORMS=cpu):
    # each arch's gaps, the port's and JAX's own
    from repro.configs import ARCH_IDS
    for name in ARCH_IDS:
        (g, gm), (o, om) = check_bf16_grads(name)
        print(f"{name}: largest gap of the tree's largest value port "
              f"{g:.2e}, JAX's own {o:.2e}; median of a leaf's scale port "
              f"{gm:.2e}, JAX's own {om:.2e}")
