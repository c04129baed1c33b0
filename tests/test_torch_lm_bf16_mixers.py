"""The port's LM serving path against the JAX reference at the published
bfloat16 compute, for the ssm, hybrid and MoE archs (rwkv6, zamba2, llama4,
grok-1); the method, the bounds and the why of JAX's op-by-op run and the
injected MoE routing are tests/test_torch_lm_bf16.py's.
"""
import pytest

from repro.configs import ARCH_IDS
from tests.test_torch_lm_bf16 import (ARCHS as DENSE_ARCHS, bf16_pair,
                                      check_decode_steps, check_prefill)

ARCHS = tuple(a for a in ARCH_IDS if a not in DENSE_ARCHS)


@pytest.fixture(scope="module", params=ARCHS)
def bf16_run(request):
    return bf16_pair(request.param)


def test_two_files_cover_every_arch():
    assert len(ARCHS) == 4 and set(ARCHS) | set(DENSE_ARCHS) == set(ARCH_IDS)


def test_prefill_logits_match_jax_bf16(bf16_run):
    check_prefill(*bf16_run)


def test_decode_steps_match_jax_bf16(bf16_run):
    check_decode_steps(*bf16_run)
