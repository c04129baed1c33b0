"""SSM heads over "model" in the LM's sharded serving program
(repro_torch's `make_prefill` and `make_decode_step` with the shardings)
on four gloo ranks against JAX's jitted unsharded `prefill` and
`decode_step`, at tests/test_torch_lm_serve_mesh.py's bounds and with its
helpers: the prefill's last-token logits and caches, four teacher-forced
decode steps each from JAX's caches, every rank's gathered logits the same
bits.

  * rwkv6-smoke (4 heads) and zamba2-smoke (8 Mamba2 heads and a shared
    attention) on (2, 2) and (1, 4): a rank holds its heads' block of the
    `wkv` / `ssm` state, (B/F, H/m, ...), the reference's spec (rows on the
    FSDP axis, "ssm_heads" on "model"); `x_prev` and the conv cache stay
    whole on "model", their rows on the FSDP axis (a Mamba2 step gathers
    its new conv rows of the rank's x channels over "model");
  * the fallback on (1, 4), 2 heads that do not divide over 4
    (`ssm_head_dim` 32 on rwkv6-smoke, 64 on zamba2-smoke): every head on
    every rank, the states whole on "model".
"""
import types

import pytest

from tests.test_torch_lm_models import smoke
from tests.test_torch_lm_serve_mesh import K, _got, _jax_serve, \
    assert_tree_close
from tests.test_torch_sharding_ranks import spawn_ranks

RWKV, ZAMBA = "rwkv6-7b", "zamba2-2.7b"
#: name -> (arch, config overrides, (data, model), batch, max_len)
CASES = {
    "rwkv6-2x2": (RWKV, (), (2, 2), 4, 16),
    "rwkv6-1x4": (RWKV, (), (1, 4), 4, 16),
    "zamba2-2x2": (ZAMBA, (), (2, 2), 4, 16),
    "zamba2-1x4": (ZAMBA, (), (1, 4), 4, 16),
    "rwkv6-2heads-1x4": (RWKV, (("ssm_head_dim", 32),), (1, 4), 4, 16),
    "zamba2-2heads-1x4": (ZAMBA, (("ssm_head_dim", 64),), (1, 4), 4, 16),
}
#: the heads' state of a slot and its dim of heads in a block (B, H, ...)
HEADS = {RWKV: ("tm", "wkv"), ZAMBA: (None, "ssm")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    want, runs = {}, {}
    for name, (arch, kw, (d, m), batch, max_len) in CASES.items():
        params, head, steps, outs = _jax_serve(
            smoke(arch, "float32", **dict(kw)), batch, max_len, eager=False)
        want[name] = outs
        runs[name] = (arch, dict(kw), "float32", {"data": d, "model": m},
                      params, head, max_len, steps)
    out = spawn_ranks(4, [("serve", "lm_serve_mesh", dict(runs=runs))],
                      tmp_path_factory.mktemp("ssm_serve"))
    return want, out


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_matches_jax(served, name):
    want, got = _got(served, name)
    (jl, jc), (tl, tc) = want[0], got["steps"][0]
    assert_tree_close(jl, tl, f"{name} prefill logits")
    assert_tree_close(jc, tc, f"{name} prefill caches")


@pytest.mark.parametrize("name", list(CASES))
def test_decode_steps_match_jax(served, name):
    want, got = _got(served, name)
    for i in range(1, K + 1):
        (jl, jc), (tl, tc) = want[i], got["steps"][i]
        assert_tree_close(jl, tl, f"{name} step {i} logits")
        assert_tree_close(jc, tc, f"{name} step {i} caches")


def _state(tree, arch):
    sub, key = HEADS[arch]
    slot = tree["slots"][0]
    return (slot[sub] if sub else slot), key


@pytest.mark.parametrize("name", list(CASES))
def test_a_rank_holds_its_heads_state(served, name):
    """The prefill's cache blocks on every rank: the heads' state (B/F,
    H/m, ...) where the heads divide over "model", (B/F, H, ...) in the
    fallback; `x_prev` and `conv` whole (B/F, ..., their whole width)."""
    from repro_torch.models.ssm import n_heads

    arch, kw, (d, m), batch, _ = CASES[name]
    cfg = smoke(arch, "float32", **dict(kw))
    H = n_heads(cfg, "rwkv" if arch == RWKV else "mamba")
    heads = H // m if H % m == 0 else H
    _, out = served
    for r in out:
        blocks = r["serve"][name]["blocks"]
        st, key = _state(blocks, arch)
        # stacked over the groups: (G, B/F, heads, ...)
        assert st[key][1:3] == (batch // d, heads), st[key]
        whole = st["conv"][-1] if arch == ZAMBA else st["x_prev"][-1]
        width = (2 * cfg.d_model + 2 * cfg.ssm_state if arch == ZAMBA
                 else cfg.d_model)
        assert whole == width and st.get("x_prev", st.get("conv"))[1] == \
            batch // d


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_state_specs_put_heads_on_model(arch, mesh):
    """`Model.cache_shardings`: the heads' state on the reference's spec,
    its rows on the FSDP axis and its heads on "model"; `x_prev` and
    `conv` on the FSDP axis alone."""
    from repro_torch.models import build_model

    d, m = mesh
    shape = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": d, "model": m})
    csh = build_model(smoke(arch, "float32")).cache_shardings(shape, 4, 16)
    st, key = _state(csh, arch)
    assert tuple(st[key].spec)[1:3] == ("data", "model"), st[key].spec
    for k in ("x_prev", "conv"):
        if k in st:
            assert tuple(st[k].spec)[1] == "data"
            assert "model" not in tuple(st[k].spec), st[k].spec
    if arch == RWKV:
        assert "model" not in tuple(csh["slots"][0]["cm"]["x_prev"].spec)
