"""The port's training step against the JAX reference at float32 compute for
the MoE family (grok-1's top-2 experts; llama4's top-1 and shared
expert, interleaved with attention): the gradients of `train_loss` and one step (microbatches 1 and 2;
remat "full" and "none"), at the bounds of tests/test_torch_lm_train.py,
whose helpers run them.
"""
import pytest
import torch

from tests.test_torch_lm_train import check_grads, check_step, leaves

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_match_jax(arch):
    check_grads(arch)


@pytest.mark.parametrize("nmb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, nmb):
    """One step, remat "full" and "none", against JAX's jitted step; the
    two port runs bit for bit."""
    full, mfull = check_step(arch, nmb, "full")
    none, mnone = check_step(arch, nmb, "none")
    assert float(mfull["loss"]) == float(mnone["loss"])
    for (p, a), (_, b) in zip(leaves(full), leaves(none)):
        assert torch.equal(a, b), p
