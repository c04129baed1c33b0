"""The port's LM configs, batch helpers, serve driver and the reference's
model smoke tests, on the CPU.

  * Every config of `repro_torch.configs` (all ten archs' full and smoke
    configs, the embedding workloads), `SHAPES`, the `RunConfig` defaults,
    the arch ids and the shape cells equal `repro.configs`' field for field
    (`dataclasses.asdict`).
  * The MoE pieces: `_capacity` equal to the reference's over a grid, and
    `jax.lax.top_k`'s tie order (the lower index first) on equal gates.
  * `batch_for`: deterministic by (step, host), JAX's shapes and dtypes in
    every mode, `vision_embeds` for vlm; `batch_specs` as `meta` tensors of
    JAX's shapes and dtypes; `convert.lm_tree_from_numpy` keeps every dtype
    (bfloat16 bit for bit).
  * Mirrors of tests/test_models_smoke.py on the port: forward shapes and
    finite logits for every arch, decode against prefill for
    `CONSISTENCY_ARCHS` (5e-2, the port's own chain of decode steps), MoE
    with identical experts equal to one dense FFN (5e-2), the exact
    published numbers.
  * `python -m repro_torch.launch.serve --device cpu` as a subprocess, and
    the sampler's draws.
  * One `cuda`-marked case: a smoke config's prefill and decode steps on
    the card against the CPU (skipped inside a fixture without a card).
  * The new modules are lint-clean under the port's RPR rules.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import batch_for as jbatch_for
from repro.data import batch_specs as jbatch_specs
from repro.models.moe import _capacity as jcapacity
from repro_torch import configs
from repro_torch.analysis.lint import lint_paths
from repro_torch.configs import (ARCH_IDS, RunConfig, get_config,
                                 get_smoke_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_tree_from_numpy
from repro_torch.data import batch_for, batch_specs
from repro_torch.launch.serve import sample_tokens
from repro_torch.models import build_model, make_decode_step, make_prefill
from repro_torch.models.layers import mlp
from repro_torch.models.moe import _capacity, _top_k, init_moe, moe_ffn

ROOT = Path(__file__).resolve().parents[1]
CONSISTENCY_ARCHS = ["yi-34b", "qwen2-7b", "nemotron-4-340b", "rwkv6-7b",
                     "zamba2-2.7b", "grok-1-314b", "musicgen-medium"]


# -- configs -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference(arch):
    assert (dataclasses.asdict(get_config(arch))
            == dataclasses.asdict(jconfigs.get_config(arch)))
    assert (dataclasses.asdict(get_smoke_config(arch))
            == dataclasses.asdict(jconfigs.get_smoke_config(arch)))
    assert get_config(arch).full_attention == \
        jconfigs.get_config(arch).full_attention
    assert ([dataclasses.asdict(c) for c in configs.shape_cells(arch)]
            == [dataclasses.asdict(c) for c in jconfigs.shape_cells(arch)])
    assert ([(dataclasses.asdict(c), why)
             for c, why in configs.skipped_cells(arch)]
            == [(dataclasses.asdict(c), why)
                for c, why in jconfigs.skipped_cells(arch)])


@pytest.mark.parametrize("arch", [*jconfigs.EMBEDDING_ARCHS, "smoke"])
def test_embedding_configs_equal_reference(arch):
    if arch == "smoke":
        got = get_smoke_config("embedding-coil20")
        want = jconfigs.get_smoke_config("embedding-coil20")
    else:
        got, want = get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_registry_shapes_and_run_defaults_equal_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.EMBEDDING_ARCHS == jconfigs.EMBEDDING_ARCHS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jconfigs.SHAPES.items()})
    assert (dataclasses.asdict(configs.RunConfig())
            == dataclasses.asdict(jconfigs.RunConfig()))
    assert ([f.name for f in dataclasses.fields(configs.ModelConfig)]
            == [f.name for f in dataclasses.fields(jconfigs.ModelConfig)])
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")


def test_full_configs_exact():
    """The exact published numbers (tests/test_models_smoke.py)."""
    c = get_config("nemotron-4-340b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (96, 18432, 96, 8, 73728, 256000)
    assert c.mlp == "squared_relu"
    c = get_config("yi-34b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (60, 7168, 56, 8, 20480, 64000)
    c = get_config("qwen2-7b")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads,
            c.d_ff, c.vocab_size) == (28, 3584, 28, 4, 18944, 152064)
    assert c.qkv_bias
    c = get_config("llama4-maverick-400b-a17b")
    assert (c.num_experts, c.experts_per_token, c.moe_shared_expert) == (
        128, 1, True)
    c = get_config("grok-1-314b")
    assert (c.num_experts, c.experts_per_token) == (8, 2)
    c = get_config("rwkv6-7b")
    assert c.attention_free and not c.full_attention
    c = get_config("zamba2-2.7b")
    assert c.ssm_state == 64 and not c.full_attention
    c = get_config("musicgen-medium")
    assert c.n_codebooks == 4 and c.vocab_size == 2048
    c = get_config("llama-3.2-vision-90b")
    assert c.cross_attn_every == 5 and c.num_layers == 100


# -- MoE pieces ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ["grok-1-314b",
                                  "llama4-maverick-400b-a17b"])
def test_capacity_equals_reference(arch):
    for base in (get_config(arch), get_smoke_config(arch)):
        for cf in (0.3, 1.0, 1.25, 2.0, 8.0):
            cfg = dataclasses.replace(base, capacity_factor=cf)
            for s in (1, 2, 3, 7, 8, 31, 32, 33, 64, 100, 4096, 32768):
                assert _capacity(s, cfg) == jcapacity(s, cfg), (s, cf)


def test_top_k_ties_go_to_the_lower_index():
    """Equal gates: jax.lax.top_k takes the lower index first; so must the
    port, in `_top_k` and in a whole MoE layer with a zero router (every
    gate 1/E, the tokens routed to experts 0..K-1)."""
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.1, 0.5]], np.float32)
    for k in (1, 2, 3, 4):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = _top_k(torch.tensor(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    from repro.models.moe import init_moe as jinit_moe
    from repro.models.moe import moe_ffn as jmoe_ffn
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"),
                              compute_dtype="float32", capacity_factor=1.0)
    p, _ = jinit_moe(jax.random.PRNGKey(3), cfg)
    p = {**p, "router": jnp.zeros_like(p["router"])}
    xs = jax.random.normal(jax.random.PRNGKey(4), (2, 8, cfg.d_model))
    want = np.asarray(jmoe_ffn(p, cfg, xs))
    got = moe_ffn(lm_tree_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
                  cfg, torch.tensor(np.asarray(xs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_moe_matches_dense_when_experts_identical():
    """With identical experts and no capacity drops, MoE == one dense FFN
    (tests/test_models_smoke.py, 5e-2 at bf16)."""
    cfg = dataclasses.replace(
        get_smoke_config("grok-1-314b"), num_experts=4, experts_per_token=2,
        capacity_factor=8.0)
    gen = torch.Generator().manual_seed(3)
    p, _ = init_moe(gen, cfg)
    for k in ("wi_gate", "wi_up", "wo"):
        p[k] = p[k][:1].expand(p[k].shape).contiguous()
    x = torch.randn((2, 8, cfg.d_model), generator=gen).to(torch.bfloat16)
    y = moe_ffn(p, cfg, x).float()
    dense = {"wi_gate": p["wi_gate"][0], "wi_up": p["wi_up"][0],
             "wo": p["wo"][0]}
    y_dense = mlp(dense, cfg, x).float()
    assert float((y - y_dense).abs().max() / y_dense.abs().max()) < 5e-2


# -- batch helpers and the converter --------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_for_shapes_dtypes_and_determinism(arch):
    cfg = get_smoke_config(arch)
    for mode in ("train", "prefill", "decode"):
        shape = ShapeConfig("c", mode, 16, 8)
        want = jbatch_for(cfg, JShapeConfig("c", mode, 16, 8), step=3,
                          host_id=1, n_hosts=2)
        got = batch_for(cfg, shape, step=3, host_id=1, n_hosts=2,
                        device="cpu")
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (mode, k)
            assert str(got[k].dtype).removeprefix("torch.") == \
                want[k].dtype.name
        tok = got["tokens"]
        assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
        again = batch_for(cfg, shape, step=3, host_id=1, n_hosts=2,
                          device="cpu")
        assert all(torch.equal(got[k], again[k]) for k in got)
        for other in (dict(step=4, host_id=1), dict(step=3, host_id=0)):
            moved = batch_for(cfg, shape, n_hosts=2, device="cpu", **other)
            assert not torch.equal(moved["tokens"], tok), other
    vlm = cfg.family == "vlm"
    b = batch_for(cfg, ShapeConfig("c", "prefill", 16, 8), device="cpu")
    assert ("vision_embeds" in b) == vlm
    if vlm:
        v = b["vision_embeds"].float()
        assert v.shape == (8, cfg.n_image_tokens, cfg.d_model)
        assert 0.01 < float(v.std()) < 0.03     # 0.02 N(0, 1)
    for mode in ("train", "prefill", "decode"):
        spec = batch_specs(cfg, ShapeConfig("c", mode, 16, 8))
        jspec = jbatch_specs(cfg, JShapeConfig("c", mode, 16, 8))
        assert spec.keys() == jspec.keys()
        for k in jspec:
            assert spec[k].device.type == "meta"
            assert tuple(spec[k].shape) == jspec[k].shape
            assert str(spec[k].dtype).removeprefix("torch.") == \
                jspec[k].dtype.name


def test_lm_tree_from_numpy_keeps_dtypes_and_bits():
    tree = {"a": [jnp.arange(5, dtype=jnp.int32),
                  jnp.linspace(-3, 3, 7, dtype=jnp.bfloat16)],
            "b": {"c": jnp.float32(2.5), "d": jnp.zeros((2, 0))}}
    got = lm_tree_from_numpy(jax.tree.map(np.asarray, tree), "cpu")
    assert got["a"][0].dtype == torch.int32
    assert got["a"][1].dtype == torch.bfloat16
    assert got["b"]["c"].shape == () and float(got["b"]["c"]) == 2.5
    assert got["b"]["d"].shape == (2, 0)
    np.testing.assert_array_equal(
        got["a"][1].view(torch.int16).numpy(),
        np.asarray(tree["a"][1]).view(np.int16))


# -- mirrors of tests/test_models_smoke.py -----------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_shapes(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, RunConfig(remat="none"))
    params, axes = model.init_params(1, device="cpu")
    assert _paths(params) == _paths(axes)
    batch = batch_for(cfg, ShapeConfig("p", "prefill", 8, 2), device="cpu")
    logits, caches = make_prefill(model)(params, batch)
    if cfg.n_codebooks:
        assert logits.shape == (2, 1, cfg.n_codebooks, cfg.vocab_size)
    else:
        assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert _paths(caches) == _paths(model.cache_axes())


def _paths(tree, path=""):
    """The leaf paths of a params/caches tree (tensors) or an axes tree
    (tuples); for the latter the tuple's length is the leaf's rank."""
    if isinstance(tree, dict):
        return {p for k, v in tree.items() for p in _paths(v, f"{path}/{k}")}
    if isinstance(tree, list):
        return {p for i, v in enumerate(tree) for p in _paths(v, f"{path}/{i}")}
    rank = len(tree) if isinstance(tree, tuple) else tree.ndim
    return {(path, rank)}


@pytest.mark.parametrize("arch", CONSISTENCY_ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-force the same tokens step by step and compare against the
    prefill logits at the final position (the port's own chain)."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = build_model(cfg, RunConfig(remat="none"))
    params, _ = model.init_params(2, device="cpu")
    T, K, B = 10, 4, 2
    full = batch_for(cfg, ShapeConfig("p", "prefill", T + K, B),
                     device="cpu")
    tokens = full["tokens"]
    ref_logits, _ = make_prefill(model)(params, full)
    _, caches = model.prefill(params, {**full, "tokens": tokens[:, :T]},
                              max_len=T + K)
    dec = make_decode_step(model)
    for i in range(K):
        logits, caches = dec(params, caches, tokens[:, T + i][:, None])
    a = ref_logits.float().reshape(B, -1)
    b = logits.float().reshape(B, -1)
    err = float((a - b).abs().max() / (a.abs().max() + 1e-30))
    assert err < 5e-2, f"{arch}: decode/prefill mismatch rel={err}"


def test_decode_leaves_its_input_caches_unchanged():
    cfg = get_smoke_config("zamba2-2.7b")
    model = build_model(cfg, RunConfig(remat="none"))
    params, _ = model.init_params(4, device="cpu")
    batch = batch_for(cfg, ShapeConfig("p", "prefill", 6, 2), device="cpu")
    _, caches = model.prefill(params, batch, max_len=8)
    before = [t.clone() for t in _tensors(caches)]
    model.decode_step(params, caches, batch["tokens"][:, :1])
    assert all(torch.equal(a, b) for a, b in zip(before, _tensors(caches)))


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def test_entry_points_default_to_cuda():
    """No silent CPU fallback: without `device`, the entry points ask for
    the current CUDA device, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    cfg = get_smoke_config("qwen2-7b")
    model = build_model(cfg)
    for call in (lambda: model.init_params(0),
                 lambda: model.init_caches(1, 4),
                 lambda: batch_for(cfg, ShapeConfig("p", "prefill", 4, 1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -- the serve driver ----------------------------------------------------------


def test_sampler_is_seeded_and_follows_the_logits():
    logits = torch.full((3, 1, 50), -30.0)
    logits[0, 0, 7] = logits[1, 0, 12] = logits[2, 0, 49] = 30.0
    g = torch.Generator().manual_seed(42)
    np.testing.assert_array_equal(sample_tokens(logits, 1.0, g).numpy(),
                                  [[7], [12], [49]])
    wide = torch.zeros((4, 1, 1000))
    a = sample_tokens(wide, 1.0, torch.Generator().manual_seed(42))
    b = sample_tokens(wide, 1.0, torch.Generator().manual_seed(42))
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert len(set(a.flatten().tolist())) > 1


@pytest.mark.parametrize("arch", ["rwkv6-7b", "musicgen-medium"])
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, "--batch", "2", "--prompt-len", "8",
         "--decode-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    name = get_smoke_config(arch).name
    assert lines[0] == f"arch={name} batch=2 prompt=8"
    assert lines[1].startswith("prefill: ")
    assert lines[2].startswith("decode: ") and "ms/step" in lines[2]
    assert lines[3].startswith("sampled token ids (first sequence): ")


# -- the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_smoke_config_on_the_card_matches_cpu(cuda_device):
    """qwen2's smoke config at float32 compute: the same params and tokens
    on the card and the CPU; a prefill and four teacher-forced decode
    steps within 1e-4 of the logits' scale."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"),
                              compute_dtype="float32")
    model = build_model(cfg, RunConfig(remat="none"))
    params, _ = model.init_params(0, device="cpu")
    batch = batch_for(cfg, ShapeConfig("p", "prefill", 14, 2), device="cpu")
    outs = []
    for p, b in ((params, batch),
                 (_to(params, cuda_device), _to(batch, cuda_device))):
        tok = b["tokens"]
        logits, caches = model.prefill(p, {"tokens": tok[:, :10]},
                                       max_len=14)
        got = [logits]
        for i in range(10, 14):
            logits, caches = model.decode_step(p, caches, tok[:, i:i + 1])
            got.append(logits)
        outs.append([t.cpu().double() for t in got])
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_new_modules_are_lint_clean():
    port = ROOT / "src" / "repro_torch"
    paths = [port / "configs", port / "models", port / "launch" / "serve.py",
             port / "data" / "synthetic.py", port / "convert.py"]
    assert lint_paths(paths, root=ROOT) == []
