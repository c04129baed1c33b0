"""The port's roofline module (repro_torch.launch.roofline) against JAX's.

  * `total_params`, `active_params` and `model_flops_for` equal the
    reference's exactly, for every arch of `ARCH_IDS` and every shape of
    `SHAPES` (pure arithmetic on the configs, copied verbatim);
  * the reference's size and MoE checks (tests/test_roofline.py:8-42) on
    the port's configs;
  * `analyze`'s terms, `dominant` and `useful_ratio` on a hand-built
    `Cost`, against the H100 peaks the module states.
"""
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch.hlo_cost import COLLECTIVES, Cost


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert rl.total_params(cfg) == jrl.total_params(jcfg)
    assert rl.active_params(cfg) == jrl.active_params(jcfg)
    assert set(SHAPES) == set(JSHAPES)
    for name, shape in SHAPES.items():
        assert rl.model_flops_for(cfg, shape) == jrl.model_flops_for(
            jcfg, JSHAPES[name]), name


def test_param_counts_match_known_sizes():
    """Sanity vs published parameter counts (tests/test_roofline.py's
    bands: non-embedding params, a wider band for small models)."""
    known = {
        "yi-34b": 34e9,
        "qwen2-7b": 7e9,
        "nemotron-4-340b": 340e9,
        "grok-1-314b": 314e9,
        "musicgen-medium": 1.5e9,
        "rwkv6-7b": 7e9,
    }
    for arch, expect in known.items():
        n = rl.total_params(get_config(arch))
        assert 0.6 * expect < n < 1.25 * expect, (arch, n, expect)


def test_moe_active_far_below_total():
    cfg = get_config("llama4-maverick-400b-a17b")
    assert rl.active_params(cfg) < 0.15 * rl.total_params(cfg)
    cfg = get_config("grok-1-314b")
    assert rl.active_params(cfg) < 0.45 * rl.total_params(cfg)


def test_model_flops_modes():
    cfg = get_config("yi-34b")
    t = rl.model_flops_for(cfg, SHAPES["train_4k"])
    p = rl.model_flops_for(cfg, SHAPES["prefill_32k"])
    d = rl.model_flops_for(cfg, SHAPES["decode_32k"])
    assert t / p == pytest.approx(3.0, rel=1e-6)
    assert d == pytest.approx(2 * rl.active_params(cfg) * 128, rel=1e-6)


def test_peaks_are_the_h100s():
    """NVIDIA H100 80GB HBM3 (SXM) at 700 W, dense: bf16 tensor cores,
    HBM3, NVLink each way; no TPU figure stays."""
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert rl.COLLECTIVE_OPS == jrl.COLLECTIVE_OPS == COLLECTIVES


@pytest.mark.parametrize("flops,byt,coll,dominant", [
    (2e12, 1e6, 0, "compute"),
    (1e9, 8e9, 1e6, "memory"),
    (1e6, 1e6, 5e9, "collective"),
])
def test_terms_and_dominance(flops, byt, coll, dominant):
    cost = Cost(flops, byt, {k: 0.0 for k in COLLECTIVES})
    cost.collective_bytes["all-reduce"] = coll / 2
    cost.collective_bytes["all-gather"] = coll / 2
    r = rl.analyze(cost, n_chips=256, model_flops=2 * 1024 ** 3)
    assert r.flops_per_chip == flops and r.bytes_per_chip == byt
    assert r.compute_s == flops / rl.PEAK_FLOPS
    assert r.memory_s == byt / rl.HBM_BW
    assert r.collective_s == coll / rl.ICI_BW
    assert r.collective_bytes_per_chip == coll
    assert r.collectives == rl.collective_bytes(cost)
    assert r.dominant == dominant
    assert r.useful_ratio == 2 * 1024 ** 3 / (flops * 256)
    assert set(r.as_dict()) == set(jrl.Roofline.__dataclass_fields__)
    assert rl.analyze(Cost(), 1, 1.0).useful_ratio == 0.0
