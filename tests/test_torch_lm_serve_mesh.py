"""The LM's sharded serving program (repro_torch's `make_prefill` and
`make_decode_step` with the shardings: params as blocks, the batch's rows
over the FSDP axes, the KV cache on "kv_heads" or "kv_seq") on four gloo
ranks against JAX's jitted unsharded `prefill` and `decode_step`.

For each case, JAX's params (cut into each rank's blocks by their
`NamedSharding`) and tokens are carried across at float32 compute: the
prefill's last-token logits, the caches gathered from the blocks, and
four teacher-forced decode steps, each from JAX's caches (cut into blocks)
and the next token, with their logits and gathered caches, at
tests/test_torch_lm_models.py's bounds (float32 within 1e-4 of a leaf's
scale, a bf16 cache within one ulp, ints exactly); every rank's gathered
logits the same bits.  The cases:

  * qwen2-smoke (4 heads, 2 kv heads) on (2, 2): the caches on this rank's
    kv heads ("kv_heads"), q on its heads;
  * on (1, 4): 2 kv heads do not divide over 4, so the slots do
    ("kv_seq"): the token written on the rank that holds its slot, the
    softmax combined over "model";
  * on (4, 1), FSDP alone, and with a batch of 2 rows that does not divide
    over 4 (every rank computes every row);
  * 6 heads on (1, 4): q, k and v gathered over "model", "kv_seq";
  * a max_len of 14, which does not divide over 4: the cache whole;
  * a max_len of 12 with decode steps at positions 10..13: past max_len
    the last slot, on the last "model" rank, is overwritten (JAX's clamp);
  * the MoE (grok-1) smoke on (2, 2), its 4 experts 2 a rank, and the
    SSM (rwkv6) smoke on (2, 2), its mixers on a rank's 2 of 4 heads, the
    `wkv` state its heads' block (more MoE and the vision cases:
    tests/test_torch_lm_expert_parallel_serve.py; more SSM cases:
    tests/test_torch_lm_ssm_parallel_serve.py);
  * the hybrid (zamba2) smoke with an 8-token window under a 10-token
    prompt, its shared attention's ring (slot == position % 8) on (2, 2)
    ("kv_heads") and, with 2 kv heads, on (1, 4) ("kv_seq"), two rows: at
    four the first decode step writes one element of v one bf16 ulp from
    JAX's (1.0234375 against 1.03125, a float32 value on a rounding edge),
    in the one-rank port as on every mesh, and the token attends to it in
    that step, which moves its logits by 3e-4 of their scale;
  * qwen2-smoke at bf16 compute on (1, 4) against JAX op by op
    (tests/test_torch_lm_bf16.py): logits within the reference's 5e-2.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from tests.test_torch_lm_bf16 import TOL_LOGITS
from tests.test_torch_lm_models import (assert_tree_close, leaves, rel_gap,
                                        smoke, to_numpy)
from tests.test_torch_sharding_ranks import spawn_ranks

T, K = 10, 4                # prompt, teacher-forced decode steps
RING = (("attn_window", 8),)
#: name -> (arch, config overrides, compute, (data, model), batch,
#: max_len, the first KV cache's layout on "model")
CASES = {
    "qwen2-2x2": ("qwen2-7b", (), "float32", (2, 2), 4, 16, "kv_heads"),
    "qwen2-1x4": ("qwen2-7b", (), "float32", (1, 4), 4, 16, "kv_seq"),
    "qwen2-4x1": ("qwen2-7b", (), "float32", (4, 1), 4, 16, None),
    "qwen2-4x1-2rows": ("qwen2-7b", (), "float32", (4, 1), 2, 16, None),
    "qwen2-6heads-1x4": ("qwen2-7b", (("num_heads", 6), ("num_kv_heads", 2),
                                      ("head_dim", 16)),
                         "float32", (1, 4), 4, 16, "kv_seq"),
    "qwen2-1x4-len14": ("qwen2-7b", (), "float32", (1, 4), 4, 14, None),
    "qwen2-1x4-past": ("qwen2-7b", (), "float32", (1, 4), 4, 12, "kv_seq"),
    "grok-2x2": ("grok-1-314b", (), "float32", (2, 2), 4, 16, "kv_heads"),
    "rwkv6-2x2": ("rwkv6-7b", (), "float32", (2, 2), 4, 16, None),
    "zamba2-ring-2x2": ("zamba2-2.7b", RING, "float32", (2, 2), 2, 16,
                        "kv_heads"),
    "zamba2-ring-1x4": ("zamba2-2.7b", RING + (("num_kv_heads", 2),),
                        "float32", (1, 4), 2, 16, "kv_seq"),
    "qwen2-bf16-1x4": ("qwen2-7b", (), "bfloat16", (1, 4), 4, 16, "kv_seq"),
}


def _jax_serve(cfg, batch: int, max_len: int, eager: bool, edit=None):
    """JAX's prefill over T tokens and K decode steps, each from the last
    one's caches and the next token: (params, the prompt batch, [(caches
    before step, its tokens)], [(logits, caches)] of the prefill and each
    step), as numpy.  `edit(params)` returns the params to serve in place
    of the drawn ones."""
    run = RunConfig(remat="none", scan_layers=not eager)
    jm = jbuild_model(cfg, run)
    params, _ = jm.init_params(jax.random.PRNGKey(2))
    if edit is not None:
        params = edit(params)
    full = jbatch_for(cfg, ShapeConfig("p", "prefill", T + K, batch))
    head = {**full, "tokens": full["tokens"][:, :T]}

    def prefill(p, b):
        return jm.prefill(p, b, max_len=max_len)

    decode = jm.decode_step
    if not eager:
        prefill, decode = jax.jit(prefill), jax.jit(decode)
    outs = [prefill(params, head)]
    steps = []
    for i in range(K):
        tok = full["tokens"][:, T + i][:, None]
        steps.append((to_numpy(outs[-1][1]), to_numpy(tok)))
        outs.append(decode(params, outs[-1][1], tok))
    return (to_numpy(params), to_numpy(head), steps,
            [to_numpy(o) for o in outs])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    want, runs = {}, {}
    for name, (arch, kw, compute, (d, m), batch, max_len,
               _) in CASES.items():
        cfg = smoke(arch, compute, **dict(kw))
        params, head, steps, outs = _jax_serve(cfg, batch, max_len,
                                               eager=compute != "float32")
        want[name] = outs
        runs[name] = (arch, dict(kw), compute, {"data": d, "model": m},
                      params, head, max_len, steps)
    out = spawn_ranks(4, [("serve", "lm_serve_mesh", dict(runs=runs))],
                      tmp_path_factory.mktemp("serve"))
    return want, out


def _got(served, name):
    want, out = served
    got = [r["serve"][name] for r in out]
    # every rank gathers the same logits, bit for bit
    for r in got[1:]:
        for (a, _), (b, _) in zip(got[0]["steps"], r["steps"]):
            assert torch.equal(a, b), name
    return want[name], got[0]


F32 = [n for n, c in CASES.items() if c[2] == "float32"]


@pytest.mark.parametrize("name", F32)
def test_cache_layout_is_the_references(served, name):
    """The first KV cache's spec: its heads on "model" where KV divides,
    else its slots where max_len does, else neither; its rows on the FSDP
    axis where the batch divides (an axis of size 1 divides every dim)."""
    _, got = _got(served, name)
    layout, spec = CASES[name][-1], got["spec"]
    (d, m), batch = CASES[name][3], CASES[name][4]
    dims = {"kv_seq": 2, "kv_heads": 3}
    on_model = [i for i, e in enumerate(spec) if e == "model"]
    if m > 1:
        assert on_model == ([dims[layout]] if layout else []), spec
    else:
        assert layout is None
    assert (spec[1] == "data") == (batch % d == 0), spec


@pytest.mark.parametrize("name", F32)
def test_sharded_prefill_matches_jax(served, name):
    want, got = _got(served, name)
    (jl, jc), (tl, tc) = want[0], got["steps"][0]
    assert_tree_close(jl, tl, f"{name} prefill logits")
    assert_tree_close(jc, tc, f"{name} prefill caches")


@pytest.mark.parametrize("name", F32)
def test_sharded_decode_steps_match_jax(served, name):
    want, got = _got(served, name)
    for i in range(1, K + 1):
        (jl, jc), (tl, tc) = want[i], got["steps"][i]
        assert_tree_close(jl, tl, f"{name} step {i} logits")
        assert_tree_close(jc, tc, f"{name} step {i} caches")


def test_decode_past_max_len_overwrites_the_last_slot(served):
    """Steps at positions 12 and 13 of a 12-slot cache split over 4 ranks:
    both land in slot 11 (the last rank's last slot), as JAX's clamp."""
    _, got = _got(served, "qwen2-1x4-past")
    slot_pos = got["steps"][-1][1]["slots"][0]["slot_pos"]
    assert slot_pos.shape[-1] == 12
    assert torch.equal(slot_pos[0], torch.arange(12, dtype=torch.int32)
                       .where(torch.arange(12) < 11, torch.tensor(13)))


def test_sharded_bf16_within_the_references_bound(served):
    want, got = _got(served, "qwen2-bf16-1x4")
    for i in range(K + 1):
        (jl, jc), (tl, tc) = want[i], got["steps"][i]
        assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == jl.shape
        gap = rel_gap(jl, tl)
        assert gap < TOL_LOGITS, f"step {i}: logits rel gap {gap}"
        assert dict(leaves(jc)).keys() == dict(leaves(tc)).keys()


def test_cases_cover_every_layout():
    """With tests/test_torch_lm_expert_parallel_serve.py's cases (the
    experts and the vision cross-attention on "model")."""
    from tests.test_torch_lm_expert_parallel_serve import CASES as EP
    cases = {**CASES, **EP}
    assert {c[-1] for c in cases.values()} == {"kv_heads", "kv_seq", None}
    assert {smoke(c[0], "float32").family for c in cases.values()} == {
        "dense", "moe", "ssm", "hybrid", "vlm"}
