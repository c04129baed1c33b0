"""The port's Checkpointer with the LM's train state, against the reference's:
bfloat16 leaves and `sharding_tree=`.

A JAX train state with bfloat16 Adam moments (`RunConfig(moment_dtype=
"bfloat16")`) is saved by each package and restored by the other.  The two
directories hold the same manifest (treedef, shapes, dtypes "bfloat16" and
"float32" and "int32", SHA-256 prefixes) and the same bytes in every
``arr_<i>.npy`` (a bfloat16 leaf is a ``'<V2'`` record of its bits).  The
port restores bfloat16 tensors bit for bit; the reference restores its own
bfloat16 leaves as two-byte void records (`np.load` of ``'<V2'``), which
hold the port's bits.  `restore(..., sharding_tree=)` hands each leaf to
its sharding (one for the whole tree, or a tree of them), as the elastic
re-shard of tests/test_torch_lm_sharding.py does on four ranks.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import Checkpointer as JCheckpointer
from repro.configs import RunConfig as JRunConfig
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build_model as jbuild_model
from repro.models import init_train_state as jinit_train_state
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.models import build_model, init_train_state
from tests.test_torch_lm_models import leaves, to_numpy, to_port


@pytest.fixture(scope="module")
def jax_state():
    """JAX's qwen2-smoke train state with bf16 moments, its numbers moved
    off zero (m and v start at zero) so that every leaf's bits matter."""
    jm = jbuild_model(jget_smoke_config("qwen2-7b"),
                      JRunConfig(moment_dtype="bfloat16"))
    state, _ = jinit_train_state(jm, jax.random.PRNGKey(4))
    opt = state["opt"]
    opt = {"m": jax.tree.map(lambda m, p: (0.01 * p).astype(m.dtype),
                             opt["m"], state["params"]),
           "v": jax.tree.map(lambda v, p: (1e-4 * p * p).astype(v.dtype),
                             opt["v"], state["params"]),
           "count": opt["count"] + 7}
    return {**state, "opt": opt, "step": state["step"] + 7}


def _port_example():
    model = build_model(get_smoke_config("qwen2-7b"),
                        RunConfig(moment_dtype="bfloat16"))
    state, _ = init_train_state(model, 0, device="cpu")
    return state


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _files(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path)) if name.endswith(".npy")}


def test_bf16_train_state_crosses_both_ways(jax_state, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCheckpointer(jdir).save(7, jax_state)
    example = _port_example()
    assert all(t.dtype == torch.bfloat16
               for _, t in leaves(example["opt"]["m"]))
    # JAX -> port: bfloat16 tensors, bit for bit
    got = Checkpointer(jdir).restore(7, example)
    want = to_port(jax_state)
    for (path, a), (_, b) in zip(leaves(want), leaves(got)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), path
    # port -> disk: the reference's manifest and bytes
    Checkpointer(tdir).save(7, got)
    jm = _manifest(os.path.join(jdir, "step_000000000007"))
    tm = _manifest(os.path.join(tdir, "step_000000000007"))
    assert tm == jm
    assert {a["dtype"] for a in tm["arrays"]} == {"bfloat16", "float32",
                                                  "int32"}
    assert (_files(os.path.join(tdir, "step_000000000007"))
            == _files(os.path.join(jdir, "step_000000000007")))
    # port -> JAX: its loader verifies the hashes; bf16 comes back as the
    # two-byte records of the port's bits
    back = JCheckpointer(tdir).restore(7, jax_state)
    for (path, a), (_, b) in zip(leaves(to_numpy(jax_state)),
                                 leaves(jax.tree.map(np.asarray, back))):
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.dtype("V2"), path
            np.testing.assert_array_equal(b.view(np.int16),
                                          a.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)


class _FirstRows:
    """A sharding stand-in: the first half of dim 0 (the whole of a
    scalar), what `NamedSharding.shard` does for a rank's block."""

    def shard(self, x):
        return x if x.ndim == 0 else x[:x.shape[0] // 2].clone()


def test_restore_places_each_leaf_by_its_sharding(jax_state, tmp_path):
    JCheckpointer(str(tmp_path)).save(7, jax_state)
    example = _port_example()
    whole = Checkpointer(str(tmp_path)).restore(7, example)
    one = Checkpointer(str(tmp_path)).restore(7, example,
                                              sharding_tree=_FirstRows())
    step, tree = Checkpointer(str(tmp_path)).restore_latest(
        example, sharding_tree=jax.tree.map(lambda _: _FirstRows(), example))
    assert step == 7
    for (path, a), (_, b), (_, c) in zip(leaves(whole), leaves(one),
                                         leaves(tree)):
        want = a if a.ndim == 0 else a[:a.shape[0] // 2]
        assert b.dtype == a.dtype and torch.equal(b, want), path
        assert torch.equal(c, want), path
