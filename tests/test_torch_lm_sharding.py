"""The port's sharding rules (repro_torch.distributed.sharding), its
sharded train step on gloo ranks, and `launch/train.py`, against the
JAX reference.

  * `spec_for` through `tree_shardings`, and `batch_shardings`, against
    JAX's on abstract meshes of shapes (1, 1), (4, 2), (2, 4), (16, 16)
    and (2, 16, 16): every leaf of every arch's FULL config (the axes and
    shapes from `params_specs` on `meta`; JAX's from its `eval_shape`)
    and of its train batch.  The specs must be equal.
  * `NamedSharding.shard` / `gather` on one process against slicing; the
    activation constraint returns its input where nothing is split over
    "model" (tests/test_torch_lm_tensor_parallel.py holds its re-lays on
    a real mesh).
  * Four gloo ranks (tests/test_torch_sharding_ranks.py): three steps of
    qwen2-smoke (float32 compute) on a (2, 2) mesh against JAX's three
    unsharded steps
    (losses at rtol 1e-5, the state within 1e-4 of a leaf's scale or
    3e-5 of its tree's, tests/test_torch_lm_train.py's bounds over several
    steps), a save, a
    restore onto a (4, 1) mesh through `sharding_tree`, and step 4 against
    JAX's fourth: the counterpart of tests/test_elastic.py.
  * `launch/train.py`'s `main` on the CPU for a few smoke steps with
    `--ckpt`, then again, resuming.
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig
from repro.data import batch_for as jbatch_for
from repro.distributed import sharding as jsharding
from repro.launch.mesh import make_abstract_mesh
from repro.models import build_model as jbuild_model
from repro.models import init_train_state as jinit_train_state
from repro.models import make_train_step as jmake_train_step
from repro.models import params_specs as jparams_specs
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.configs import RunConfig, get_config
from repro_torch.configs.base import ShapeConfig as TShapeConfig
from repro_torch.data import batch_specs
from repro_torch.distributed import sharding
from repro_torch.models import build_model, params_specs
from repro_torch.tree import leaves
from tests.test_torch_lm_models import leaves as path_leaves
from tests.test_torch_lm_models import smoke, to_numpy
from tests.test_torch_lm_train import assert_leaves_close
from tests.test_torch_sharding_ranks import spawn_ranks

MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _port_mesh(shape, names):
    """What the rules read of a mesh: its axis names and sizes."""
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tree_and_batch_shardings_match_jax(arch):
    jp, jaxes = jparams_specs(jbuild_model(jget_config(arch), JRunConfig()))
    tp, taxes = params_specs(build_model(get_config(arch), RunConfig()))
    jbatch = jax.eval_shape(lambda: jbatch_for(
        jget_config(arch), ShapeConfig("t", "train", 64, 256)))
    tbatch = batch_specs(get_config(arch), TShapeConfig("t", "train", 64,
                                                        256))
    for shape, names in MESHES:
        jmesh, tmesh = make_abstract_mesh(shape, names), _port_mesh(shape,
                                                                    names)
        want = [tuple(s.spec) for s in jax.tree.leaves(
            jsharding.tree_shardings(jmesh, jaxes, jp))]
        got = [tuple(s.spec) for s in leaves(
            sharding.tree_shardings(tmesh, taxes, tp))]
        assert got == want, (arch, shape)
        want = [tuple(s.spec) for s in jax.tree.leaves(
            jsharding.batch_shardings(jmesh, jbatch))]
        got = [tuple(s.spec) for s in leaves(
            sharding.batch_shardings(tmesh, tbatch))]
        assert got == want, (arch, shape)
        assert sharding.fsdp_axes(tmesh) == jsharding.fsdp_axes(jmesh)
        assert (tuple(sharding.scalar_sharding(tmesh).spec)
                == tuple(jsharding.scalar_sharding(jmesh).spec))


@pytest.mark.parametrize("logical,shape", [
    (("embed", "mlp"), (64, 48)), (("layers", "embed", "kv_heads"),
                                   (2, 32, 6)),
    (("batch", "kv_seq", "kv_heads", None), (8, 64, 8, 16)),
    (("batch", "kv_seq", "kv_heads", None), (8, 64, 3, 16)),
    (("experts", "embed", "mlp"), (8, 64, 48)), ((), ())])
def test_spec_for_matches_jax(logical, shape):
    """Priority order (kv_heads before kv_seq's fallback), divisibility
    and one claim of an axis a tensor, on every mesh shape."""
    for mshape, names in MESHES:
        want = jsharding.spec_for(make_abstract_mesh(mshape, names), logical,
                                  shape)
        got = sharding.spec_for(_port_mesh(mshape, names), logical, shape)
        assert tuple(got) == tuple(want), (logical, shape, mshape)


def test_activation_constraint_returns_its_input():
    """The hook re-lays an activation over "model" only under the sharded
    step's tensor-parallel context on a mesh whose "model" axis is wider
    than 1: on a mesh whose axes are of size 1, and outside the context
    (the port's serving is replicated: no `TensorParallel` is passed), it
    returns its input; the specs it reads are the reference's."""
    from repro_torch.distributed.collectives import TensorParallel
    from repro_torch.models import hooks

    x = torch.randn(8, 6, 4, 4, generator=torch.Generator().manual_seed(0))
    ones = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                 axis_names=("data", "model"), rank=0,
                                 axis_group=None)
    for mesh in (_port_mesh((4, 2), ("data", "model")), ones):
        fn = sharding.make_activation_constraint(mesh, RunConfig(
            act_shard_embed=True))
        for tag in ("residual", "qkv", "moe_dispatch", "moe_expert"):
            assert fn(x, tag) is x
    fn = sharding.make_activation_constraint(ones, RunConfig(
        act_shard_embed=True))
    tp = TensorParallel(ones, {})
    with hooks.tensor_parallel_scope(tp):
        for tag in ("residual", "qkv", "moe_dispatch", "moe_expert"):
            assert fn(x, tag, tp) is x
            assert hooks.constrain(x, tag) is x
    mesh = _port_mesh((4, 2), ("data", "model"))
    assert tuple(sharding.activation_spec(mesh, (8, 6, 4, 4), "qkv")) == (
        "data", None, "model", None)
    assert tuple(sharding.activation_spec(mesh, (8, 6, 4), "residual",
                                          True)) == ("data", None, "model")


def test_named_sharding_shard_and_gather_on_one_rank():
    """On a one-rank group every block is the whole tensor: `shard` and
    `gather` hand it back unchanged; `local_view` of a wider mesh's spec
    is the block its coordinates name (read without a group)."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 3},
                                 axis_names=("data", "model"),
                                 coords={"data": 1, "model": 2})
    s = sharding.NamedSharding(mesh, sharding.P(("data",), "model"))
    x = torch.arange(4 * 9.0).reshape(4, 9)
    assert torch.equal(s.local_view(x), x[2:4, 6:9])
    assert torch.equal(s.shard(x), x[2:4, 6:9])
    whole = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                  axis_names=("data", "model"))
    w = sharding.NamedSharding(whole, sharding.P(("data",), "model"))
    assert w.shard(x) is x and w.gather(x) is x and w.is_whole


# -- the data-parallel step on four gloo ranks ------------------------------------

OPT = dict(warmup_steps=2, total_steps=10)
#: a leaf's floor of its tree's scale after several steps whose batch rows
#: the ranks sum apart: a leaf far below its tree (the key bias, whose
#: gradient softmax nearly ignores) moves each step by AdamW's direction of
#: a near-rounding gradient, and four such steps pass the one-step 1e-5
TOL_TREE_STEPS = 3e-5
SHAPE = ShapeConfig("t", "train", 16, 8)        # tests/test_elastic.py's


def test_lm_train_2x2_then_elastic_4x1_matches_jax(tmp_path):
    cfg = smoke("qwen2-7b", "float32")
    run = JRunConfig(num_microbatches=2, remat="full")
    jm = jbuild_model(cfg, run)
    state, _ = jinit_train_state(jm, jax.random.PRNGKey(0))
    init = to_numpy(state)
    batches = [to_numpy(jbatch_for(cfg, SHAPE, step=s)) for s in range(4)]
    step = jax.jit(jmake_train_step(jm, JAdamWConfig(**OPT)))
    losses, states = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        states.append(to_numpy(state))

    out = spawn_ranks(4, [("lm", "lm_train", dict(
        arch="qwen2-7b", compute="float32",
        run=dict(num_microbatches=2, remat="full"),
        opt=OPT, state=init, batches=batches,
        ckdir=str(tmp_path / "ck")))], tmp_path)
    for r, res in enumerate(out):
        got = res["lm"]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        assert got["step3"] == 3 and got["step4"] == 4
        # every rank gathers the same whole state
        assert_leaves_close(states[2], got["state3"], f"rank {r} step 3 ",
                            tol_tree=TOL_TREE_STEPS)
        assert_leaves_close(states[3], got["state4"], f"rank {r} step 4 ",
                            tol_tree=TOL_TREE_STEPS)
        if r:
            for (p, a), (_, b) in zip(path_leaves(out[0]["lm"]["state4"]),
                                      path_leaves(got["state4"])):
                assert torch.equal(a, b), p
    # tests/test_elastic.py's bound on the step after the re-shard
    assert abs(out[0]["lm"]["losses"][3] - losses[2]) < 1.0


def test_launch_train_main_resumes(tmp_path, capsys):
    """`python -m repro_torch.launch.train` on the CPU: four smoke steps
    with a checkpoint every two, then six, which resumes from step 4 and
    saves step 6 (keep=3)."""
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    args = ["--device", "cpu", "--arch", "qwen2-7b", "--seq", "16",
            "--ckpt", ck, "--ckpt-every", "2"]
    assert train.main(args + ["--steps", "4"]) == 0
    first = capsys.readouterr().out
    assert "params 0.21M" in first and "step    0 loss" in first
    assert "done" in first and "resumed" not in first
    assert train.main(args + ["--steps", "6"]) == 0
    second = capsys.readouterr().out
    assert "resumed step 4" in second and "step    5 loss" in second
    from repro_torch.ckpt import Checkpointer
    assert Checkpointer(ck).all_steps() == [2, 4, 6]
    assert not torch.distributed.is_initialized()
