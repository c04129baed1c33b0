"""The LM train step's sharded program on gloo ranks (repro_torch's
distributed/collectives.py, the tensor-parallel layers and
models/train.py on a mesh) against JAX's unsharded steps and against the
whole-tensor computations.

  * Four ranks: qwen2-smoke for three steps on (2, 2) (q and kv on this
    rank's heads), (1, 4) (the kv projections' 32 columns split into half
    heads: k and v gathered over "model", q on this rank's head, its kv
    group's half) and (4, 1) (FSDP alone), with 6 heads on (1, 4) (q's
    96 columns split into 1.5 heads: q, k and v gathered over "model"),
    and the MoE (grok-1) and SSM (rwkv6) smokes on
    (2, 2), float32 compute, from JAX's state with JAX's batches, against
    JAX's three jitted unsharded steps: the losses at rtol 1e-5 and the
    whole state gathered after every step within 1e-4 of a leaf's scale or
    3e-5 of its tree's (tests/test_torch_lm_sharding.py's bounds over
    several steps); the ranks' losses bit-identical.  The SSM case's
    mixers run on a rank's heads, and RWKV6's bonus `u`'s moments are held
    within U_QUANTA (its comment).
  * Four ranks on (2, 2): each collective's forward and backward against
    the whole-tensor autograd it stands for; the vocab-parallel embedding
    (gather and one-hot, codebook tables too: bit for bit) and
    cross-entropy against the whole ones; `global_norm` over blocks, with
    leaves that several ranks hold alike, against the whole gradient's; the
    activation constraint re-laying q over "model", and returning its
    input outside the context and for the residual and the MoE tags.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.models import build_model as jbuild_model
from repro.models import init_train_state as jinit_train_state
from repro.models import make_train_step as jmake_train_step
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from tests.test_torch_lm_models import leaves as path_leaves
from tests.test_torch_lm_models import smoke, to_numpy
from tests.test_torch_lm_sharding import OPT, SHAPE, TOL_TREE_STEPS
from tests.test_torch_lm_train import assert_leaves_close
from tests.test_torch_sharding_ranks import spawn_ranks

RUN = dict(num_microbatches=2, remat="full")
#: qwen2-smoke with 6 heads of 16: wq's 96 columns split into 1.5 heads a
#: rank on (1, 4), so q, k and v are gathered over "model" and the
#: attention output is cut to this rank's columns before the row-parallel
#: wo (the case of qwen2-7b's 28 heads on the 16-way axis)
GATHER = (("num_heads", 6), ("num_kv_heads", 2), ("head_dim", 16))
#: (arch, mesh, config overrides): qwen2-smoke on three meshes and in the
#: gather case, the MoE and SSM smokes on one
CASES = (("qwen2-7b", (2, 2), ()), ("qwen2-7b", (1, 4), ()),
         ("qwen2-7b", (4, 1), ()), ("qwen2-7b", (1, 4), GATHER),
         ("grok-1-314b", (2, 2), ()), ("rwkv6-7b", (2, 2), ()))
IDS = [f"{a}{'-6heads' if kw else ''}-{d}x{m}" for a, (d, m), kw in CASES]
STEPS = 3
#: RWKV6's zero-initialised bonus `u`: its gradient's terms cancel, so
#: float32 rounding moves its moments by a large share of their scale.
#: Against the port's float64 step JAX's float32 moments lie up to 3.48e-4
#: of their scale and the sharded port's up to 2.15e-4 (rwkv6-smoke on
#: (1, 4); 1.96e-5 on (2, 2)), so the two may part by their sum: held
#: within 6e-4 of their scale against JAX's (read up to 3.68e-4 on (2, 2)
#: and 1.33e-4 on (1, 4); tests/torch_ssm_f32_readings.py)
U_QUANTA = {"/opt/m/slots/0/tm/u": 6e-4, "/opt/v/slots/0/tm/u": 6e-4}
#: the cases whose leaves take `quanta` (assert_leaves_close)
QUANTA = {"rwkv6-7b-2x2": U_QUANTA}


def _jax_steps(arch, kw, embeds_f32=False):
    """JAX's initial state, batches, losses and states after each of STEPS
    jitted steps (numpy); `embeds_f32`: the batches' vision embeddings cast
    to float32."""
    cfg = smoke(arch, "float32", **dict(kw))
    jm = jbuild_model(cfg, JRunConfig(**RUN))
    state, _ = jinit_train_state(jm, jax.random.PRNGKey(0))
    init = to_numpy(state)
    batches = [to_numpy(jbatch_for(cfg, SHAPE, step=s)) for s in range(STEPS)]
    if embeds_f32:
        batches = [{k: v.astype(np.float32) if k == "vision_embeds" else v
                    for k, v in b.items()} for b in batches]
    step = jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT)))
    losses, states = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        states.append(to_numpy(state))
    return init, batches, losses, states


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    want = {(arch, kw): _jax_steps(arch, kw)
            for arch, kw in {(a, kw) for a, _, kw in CASES}}
    runs = {name: (arch, dict(kw), "float32", RUN, {"data": d, "model": m},
                   want[arch, kw][0], want[arch, kw][1])
            for name, (arch, (d, m), kw) in zip(IDS, CASES)}
    out = spawn_ranks(4, [("mesh", "lm_mesh_steps", dict(runs=runs,
                                                         opt=OPT))],
                      tmp_path_factory.mktemp("tp"))
    return want, out


@pytest.mark.parametrize("arch,mesh,kw", CASES, ids=IDS)
def test_sharded_steps_match_jax(mesh_runs, arch, mesh, kw):
    want, out = mesh_runs
    _, _, losses, states = want[arch, kw]
    name = IDS[CASES.index((arch, mesh, kw))]
    got = [r["mesh"][name] for r in out]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]          # bit-identical
        assert r["norms"] == got[0]["norms"]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for k in range(STEPS):
        assert_leaves_close(states[k], got[0]["states"][k],
                            f"{name} step {k + 1} ", quanta=QUANTA.get(name),
                            tol_tree=TOL_TREE_STEPS)
    # every rank gathers the same whole state
    for r in got[1:]:
        for (p, a), (_, b) in zip(path_leaves(got[0]["states"][-1]),
                                  path_leaves(r["states"][-1])):
            assert torch.equal(a, b), p


# -- the collectives and the vocab-parallel layers on four ranks -------------------------


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return spawn_ranks(4, [("c", "collectives", dict(seed=11))],
                       tmp_path_factory.mktemp("coll"))


def _by_model(units, data: int):
    """The two ranks of one "model" group (data row `data`), in order."""
    rows = [u["c"] for u in units if u["c"]["coords"]["data"] == data]
    return sorted(rows, key=lambda r: r["coords"]["model"])


@pytest.mark.parametrize("data", [0, 1])
def test_collectives_forward_and_backward(units, data):
    """Each function against the whole computation: `gather` is the whole
    tensor forward and the sum of the ranks' gradients' blocks backward,
    `copy_to` sums the gradients, `reduce_from` sums the values and passes
    the gradient, `gather_from` keeps this rank's block of a gradient that
    every rank holds alike, `scatter_to` gathers the ranks' gradients."""
    pair = _by_model(units, data)
    Gs = [r["G"] for r in pair]
    whole = pair[0]["copy_to"][0]
    for i, r in enumerate(pair):
        blk = slice(3 * i, 3 * i + 3)
        y, g = r["gather"]
        assert torch.equal(y, whole)
        assert torch.allclose(g, (Gs[0] + Gs[1])[:, blk], rtol=0, atol=1e-6)
        y, g = r["copy_to"]
        assert torch.equal(y, whole)
        assert torch.allclose(g, Gs[0] + Gs[1], rtol=0, atol=1e-6)
        y, g = r["reduce_from"]
        want = (whole + pair[0]["rank"]) + (whole + pair[1]["rank"])
        assert torch.allclose(y, want, rtol=0, atol=1e-6)
        assert torch.equal(g, Gs[i])
        y, g = r["gather_from"]
        assert torch.equal(y, whole) and torch.equal(g, whole[:, blk])
        y, g = r["scatter_to"]
        assert torch.equal(y, whole[:, blk])
        assert torch.equal(g, torch.cat([G[:, :3] for G in Gs], dim=1))
    # over the FSDP group (the data axis): the ranks of one model column
    col = sorted((u["c"] for u in units
                  if u["c"]["coords"]["model"] == data),
                 key=lambda r: r["coords"]["data"])
    for i, r in enumerate(col):
        y, g = r["gather_fsdp"]
        assert torch.equal(y, whole)
        want = (col[0]["G"] + col[1]["G"])[2 * i:2 * i + 2]
        assert torch.allclose(g, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["gather", "onehot", "codebooks",
                                  "codebooks_onehot"])
def test_vocab_parallel_embedding_is_the_whole_lookup(units, kind):
    """Each rank looks up its vocab block and zeroes the rest; the sum over
    "model" is the whole lookup bit for bit (one rank holds each row; the
    codebooks' rows are summed after, in the whole lookup's order), and a
    block's gradient is its rows of the whole gradient.  The one-hot
    contraction over stacked codebook tables sums the codebooks' rows in
    another order (a rank's partial sum first): within 1e-6."""
    import types

    from repro_torch.models import layers

    r0 = units[0]["c"]
    table, tables, tok, tok3 = r0["embed_inputs"]
    t, tk = ((table, tok) if not kind.startswith("codebooks")
             else (tables, tok3))
    cfg = types.SimpleNamespace(vocab_size=16, compute_dtype="float32")
    fn = (layers.embed_tokens_onehot if kind.endswith("onehot")
          else layers.embed_tokens)
    w = t.clone().requires_grad_(True)
    y = fn({"table": w}, cfg, tk)
    y.backward(torch.ones_like(y))
    exact = kind != "codebooks_onehot"
    for u in units:
        got, g = u["c"]["embed"][kind]
        if exact:
            assert torch.equal(got, y.detach())
        else:
            assert torch.allclose(got, y.detach(), rtol=0, atol=1e-6)
        vb = 8 * u["c"]["coords"]["model"]
        assert torch.allclose(g, w.grad.narrow(-2, vb, 8), rtol=0, atol=1e-6)


def test_vocab_parallel_cross_entropy(units):
    """The max and sum of exponentials reduced over "model", the label's
    logit from its owning rank: the whole mean cross-entropy and, on each
    vocab block, its slice of the whole gradient."""
    logits, labels = units[0]["c"]["ce_inputs"]
    x = logits.clone().requires_grad_(True)
    ce = torch.mean(torch.logsumexp(x, dim=-1) - torch.take_along_dim(
        x, labels[..., None], dim=-1)[..., 0])
    ce.backward()
    want = float(ce.detach())
    for u in units:
        got, g = u["c"]["ce"]
        assert abs(got - want) <= 1e-6 * abs(want)
        vb = 8 * u["c"]["coords"]["model"]
        assert torch.allclose(g, x.grad[..., vb:vb + 8], rtol=0, atol=1e-7)


def test_global_norm_counts_each_replicated_block_once(units):
    """A leaf split over both axes, one held alike by the "model" ranks and
    one held alike by every rank: the norm over the blocks is the whole
    gradient's, the same bits on every rank."""
    got = {u["c"]["norm"][0] for u in units}
    assert len(got) == 1
    (norm,), want = got, units[0]["c"]["norm"][1]
    assert abs(norm - want) <= 1e-6 * want


def test_activation_constraint_relays_on_a_mesh(units):
    """Under the tensor-parallel context on "model" = 2 (`hooks.constrain`
    passes the `TensorParallel` to the hook): q of 4 heads held whole (the
    spec puts heads on "model") comes back as this rank's two heads,
    marked; outside the context, for the residual (whole on "model" or
    not) and the MoE tags, for an activation already in its spec's layout
    and for one whose layout no tensor-parallel code recorded (the vision
    cross-attention's, computed whole) the hook returns its input."""
    for u in units:
        r = u["c"]["relay"]
        q, res = r["inputs"]
        i = u["c"]["coords"]["model"]
        y, split = r["qkv"]
        assert split == 2 and torch.equal(y, q[:, :, 2 * i:2 * i + 2])
        assert r["residual"] and r["outside"] and r["moe"] and r["same"]
        assert r["unmarked"]
