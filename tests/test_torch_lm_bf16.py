"""The port's LM serving path against the JAX reference at the published
bfloat16 compute: the dense, vlm and audio archs here, the ssm, hybrid and
MoE ones in tests/test_torch_lm_bf16_mixers.py (one file would run past
90 s on one core).

For every arch at its smoke config with JAX's params and tokens
carried across: the prefill's and four teacher-forced decode steps'
logits within the reference's 5e-2 (tests/test_models_smoke.py:88).  JAX
runs op by op here (`scan_layers=False`, no jit): the reference's code
rounds to bf16 at every op, as the port does, while under a jit XLA keeps
a fused chain of bf16 ops in float32 (its default excess precision); on
zamba2 that alone moves the prefill logits by 6e-2 (with
`--xla_allow_excess_precision=false` the jitted gap is the op-by-op one,
2e-2).  For the MoE archs the routing (dispatch and combine, the tensors of
the `moe_dispatch` hook) is JAX's, injected through
`hooks.set_activation_constraint`: a top-1 or top-2 choice between
near-equal gates flips on a bf16 rounding (JAX against itself with its
params scaled by 1 + 1e-3 N(0, 1) moves llama4's prefill logits by up to
0.12); tests/test_torch_lm_models.py holds the routing itself exactly at
float32 compute.
"""
import pytest
import torch

from repro.configs import get_smoke_config
from tests.test_torch_lm_models import (K, leaves, rel_gap, run_pair, smoke)

TOL_LOGITS = 5e-2           # tests/test_models_smoke.py:88
ARCHS = ("llama-3.2-vision-90b", "yi-34b", "qwen2-7b", "nemotron-4-340b",
         "codeqwen1.5-7b", "musicgen-medium")


def bf16_pair(arch: str):
    cfg = smoke(arch, "bfloat16")
    return arch, run_pair(cfg, eager=True, routing=bool(cfg.num_experts))


def check_prefill(arch, out):
    (jl, _), (tl, _) = out["jax"][0], out["port"][0]
    (jl, _), (tl, _) = out["jax"][0], out["port"][0]
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
    gap = rel_gap(jl, tl)
    assert gap < TOL_LOGITS, f"{arch}: prefill logits rel gap {gap}"


def check_decode_steps(arch, out):
    for i in range(1, K + 1):
        (jl, jc), (tl, tc) = out["jax"][i], out["port"][i]
        gap = rel_gap(jl, tl)
        assert gap < TOL_LOGITS, f"{arch}: step {i} logits rel gap {gap}"
        assert dict(leaves(jc)).keys() == dict(leaves(tc)).keys()




@pytest.fixture(scope="module", params=ARCHS)
def bf16_run(request):
    return bf16_pair(request.param)


def test_families_split_over_two_files():
    assert {get_smoke_config(a).family for a in ARCHS} == {
        "dense", "vlm", "audio"}


def test_prefill_logits_match_jax_bf16(bf16_run):
    check_prefill(*bf16_run)


def test_decode_steps_match_jax_bf16(bf16_run):
    check_decode_steps(*bf16_run)
