"""The LM's forward-only `train_loss` (cross-entropy, plus the MoE
load-balance aux for grok-1 and llama4) against JAX's value at 1e-4, for
all ten archs at their smoke configs with compute dtype float32 and JAX's
params and tokens carried across.  The training step itself is ROADMAP
item 26b.
"""
import jax
import pytest
import torch

from repro.configs import ARCH_IDS, RunConfig
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro_torch.models import build_model
from tests.test_torch_lm_models import B, smoke, to_port


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_matches_jax(arch):
    """The forward-only train_loss (cross-entropy, and the MoE
    load-balance aux for grok and llama4) against JAX's at 1e-4."""
    cfg = smoke(arch, "float32")
    run = RunConfig(remat="none")
    jm = jbuild_model(cfg, run)
    params, _ = jm.init_params(jax.random.PRNGKey(8))
    batch = jbatch_for(cfg, ShapeConfig("t", "train", 8, B))
    want = float(jax.jit(jm.train_loss)(params, batch))
    got = build_model(cfg, run).train_loss(to_port(params), to_port(batch))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-4 * abs(want), (float(got), want)
