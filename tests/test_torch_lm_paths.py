"""The LM serving path's special cases against the JAX reference.

Zamba2's ring for windowed shared attention with a prompt longer than the
window, `attn_q_chunk` against unchunked, `embed_onehot` against the
gather, a decode past `max_len` (JAX's dynamic_update_slice clamps the
write onto the last slot), and the MoE routing at float32 compute
(`train_loss`: tests/test_torch_lm_loss.py).  Tolerances and
helpers are tests/test_torch_lm_models.py's.
"""
import jax
import numpy as np
import pytest

from repro.configs import RunConfig
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro.models import hooks as jhooks
from repro_torch.models import build_model, hooks
from tests.test_torch_lm_models import (B, K, TOL_F32, assert_tree_close,
                                        rel_gap, run_pair, smoke, to_port)


def test_zamba2_ring_prompt_longer_than_window():
    """attn_window = 6 < the 10-token prompt: prefill keeps the last six
    tokens in the ring order argsort(p % W), and four decode steps wrap
    around the ring."""
    cfg = smoke("zamba2-2.7b", "float32", attn_window=6)
    out = run_pair(cfg)
    want = out["jax"][0][1]["shared_attn"]
    got = out["port"][0][1]["shared_attn"]
    assert got["k"].shape[2] == 6
    np.testing.assert_array_equal(got["slot_pos"].numpy()[0],
                                  [6, 7, 8, 9, 4, 5])
    assert_tree_close(want, got, "ring")
    for i in range(K + 1):
        assert_tree_close(out["jax"][i][0], out["port"][i][0], f"step {i}")
        assert_tree_close(out["jax"][i][1], out["port"][i][1], f"step {i}")


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-2.7b"])
def test_q_chunk_matches_unchunked_and_jax(arch):
    """attn_q_chunk = 4 over 12 tokens (three chunks) against the
    unchunked port (1e-5) and JAX's chunked forward (1e-4)."""
    cfg = smoke(arch, "float32")
    chunked = RunConfig(remat="none", attn_q_chunk=4)
    jm = jbuild_model(cfg, chunked)
    params, _ = jm.init_params(jax.random.PRNGKey(5))
    batch = jbatch_for(cfg, ShapeConfig("p", "prefill", 12, B))
    want, _ = jax.jit(jm.prefill)(params, batch)
    tparams, tbatch = to_port(params), to_port(batch)
    got, _ = build_model(cfg, chunked).prefill(tparams, tbatch)
    assert_tree_close(want, got, "chunked vs JAX")
    plain, _ = build_model(cfg, RunConfig(remat="none")).prefill(
        tparams, tbatch)
    assert rel_gap(plain, got) <= 1e-5


@pytest.mark.parametrize("arch", ["qwen2-7b", "musicgen-medium"])
def test_embed_onehot_matches_gather_and_jax(arch):
    """The one-hot einsum embedding (2-D tokens, and musicgen's stacked
    codebook tables) against the gather (1e-6) and JAX's one-hot
    prefill (1e-4)."""
    cfg = smoke(arch, "float32")
    onehot = RunConfig(remat="none", embed_onehot=True)
    jm = jbuild_model(cfg, onehot)
    params, _ = jm.init_params(jax.random.PRNGKey(6))
    batch = jbatch_for(cfg, ShapeConfig("p", "prefill", 8, B))
    want, _ = jax.jit(jm.prefill)(params, batch)
    tparams, tbatch = to_port(params), to_port(batch)
    got, _ = build_model(cfg, onehot).prefill(tparams, tbatch)
    assert_tree_close(want, got, "onehot vs JAX")
    plain, _ = build_model(cfg, RunConfig(remat="none")).prefill(
        tparams, tbatch)
    assert rel_gap(plain, got) <= 1e-6


def test_decode_past_max_len_clamps_like_jax():
    """Prefill 4 tokens with max_len 5, then three decode steps: the
    second and third write past the cache, and JAX's
    dynamic_update_slice clamps them onto the last slot.  The port's own
    chain of steps is held to JAX's: every cache leaf, pos = 7 and
    slot_pos = [0, 1, 2, 3, 6] exactly."""
    cfg = smoke("qwen2-7b", "float32")
    jm, tm = (jbuild_model(cfg, RunConfig(remat="none")),
              build_model(cfg, RunConfig(remat="none")))
    params, _ = jm.init_params(jax.random.PRNGKey(7))
    full = jbatch_for(cfg, ShapeConfig("p", "prefill", 7, B))
    head = {"tokens": full["tokens"][:, :4]}
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=5))(params, head)
    tparams = to_port(params)
    _, tc = tm.prefill(tparams, to_port(head), max_len=5)
    dec = jax.jit(jm.decode_step)
    for i in range(4, 7):
        tok = full["tokens"][:, i][:, None]
        jl, jc = dec(params, jc, tok)
        tl, tc = tm.decode_step(tparams, tc, to_port(tok))
        assert_tree_close(jl, tl, f"step at pos {i} logits")
        assert_tree_close(jc, tc, f"step at pos {i} caches")
    np.testing.assert_array_equal(tc["slots"][0]["pos"].numpy(), 7)
    np.testing.assert_array_equal(tc["slots"][0]["slot_pos"].numpy()[0],
                                  [0, 1, 2, 3, 6])


def test_moe_routing_matches_jax_f32():
    """At float32 compute the port's own routing (dispatch and combine of
    every MoE call in a prefill) equals JAX's exactly, for both MoE
    archs."""
    for arch in ("grok-1-314b", "llama4-maverick-400b-a17b"):
        cfg = smoke(arch, "float32")
        run = RunConfig(remat="none", scan_layers=False)
        jm = jbuild_model(cfg, run)
        params, _ = jm.init_params(jax.random.PRNGKey(9))
        batch = jbatch_for(cfg, ShapeConfig("p", "prefill", 12, B))
        got, want = [], []
        try:
            jhooks.set_activation_constraint(
                lambda x, tag: want.append(np.asarray(x)) or x
                if tag == "moe_dispatch" else x)
            jm.prefill(params, batch)
            hooks.set_activation_constraint(
                lambda x, tag: got.append(x.clone()) or x
                if tag == "moe_dispatch" else x)
            build_model(cfg, run).prefill(to_port(params), to_port(batch))
        finally:
            jhooks.set_activation_constraint(None)
            hooks.set_activation_constraint(None)
        assert len(got) == len(want) > 0
        for a, b in zip(want, got):
            nz = a != 0
            np.testing.assert_array_equal(b.numpy() != 0, nz, err_msg=arch)
            assert rel_gap(a, b) <= TOL_F32, arch
