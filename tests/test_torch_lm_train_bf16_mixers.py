"""The gradients of `train_loss` at bf16 compute, the port against JAX's own
spread, for RWKV6, the Mamba2 hybrid, the audio and the VLM archs, at the
bounds of tests/test_torch_lm_train_bf16.py, whose helper runs them.
"""
import pytest

from tests.test_torch_lm_train_bf16 import check_bf16_grads

ARCHS = ("rwkv6-7b", "zamba2-2.7b", "musicgen-medium", "llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_bf16_within_jax_own_spread(arch):
    check_bf16_grads(arch)
