"""The port's ELL Laplacian product (repro_torch.kernels) against the JAX
reference.

On the CPU `repro_torch.kernels.ops.ell_lap_matvec` runs its plain PyTorch
oracle; it is held against the JAX oracle (`repro.kernels.ref`) and the JAX
dispatcher's jnp path, on the same numpy inputs, in float32 and with
bfloat16 storage, at the tolerances of the reference's own kernel test
(tests/test_sparse_kernel.py: rtol 5e-5 with atol 5e-5 (max|.| + 1) on
random graphs, atol 5e-6 on a calibrated graph, 1e-5 for duplicate
columns).  The port's ``layout="hbm"`` request (the staged gather on a GPU,
the oracle on the CPU) is also held against the reference's own staged
kernel, `ell_lap_matvec_pallas_hbm`, in interpret mode, at that test's
tolerance for it (rtol 1e-5, atol 1e-5 (max|.| + 1)).  The CUDA kernels
themselves run only on a GPU: tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sparse import sparse_affinities as jsparse_affinities
from repro_torch.kernels import ops, ref
from repro_torch.kernels.sparse_attractive import (ell_lap_matvec_cuda,
                                                   launch_counts)

TOL = 5e-5


def _graph(seed: int, n: int, k: int, d: int):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    return X, idx, w


def _port(X, idx, w, **kw):
    return ops.ell_lap_matvec(torch.from_numpy(X), torch.from_numpy(idx),
                              torch.from_numpy(w), **kw).numpy()


CASES = [(64, 8, 2), (96, 5, 3), (70, 8, 2), (33, 16, 5), (33, 1, 3)]


@pytest.mark.parametrize("n,k,d", CASES)
def test_oracle_matches_jax_ref(n, k, d):
    X, idx, w = _graph(n + k + d, n, k, d)
    got = ref.ell_lap_matvec_ref(torch.from_numpy(X), torch.from_numpy(idx),
                                 torch.from_numpy(w)).numpy()
    want = np.asarray(jref.ell_lap_matvec_ref(jnp.asarray(X),
                                              jnp.asarray(idx),
                                              jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * (np.abs(want).max() + 1))


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,d", CASES)
def test_dispatch_matches_jax_dispatcher(n, k, d, storage):
    """impl="torch" against the JAX dispatcher's jnp path, both rounding X
    and the weights through the storage dtype."""
    X, idx, w = _graph(3 * n + k, n, k, d)
    got = _port(X, idx, w, impl="torch", storage_dtype=storage)
    want = np.asarray(jops.ell_lap_matvec(
        jnp.asarray(X), jnp.asarray(idx), jnp.asarray(w), impl="jnp",
        storage_dtype=storage))
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * (np.abs(want).max() + 1))
    info = ops.last_dispatch("ell_lap_matvec")
    assert info == {"path": "torch", "reason": "forced-off",
                    "storage": storage}


# (n, k, d) of the staged-layout cases: ragged N against block_rows = 16,
# one slot a row, d past the kernel's four columns, k past a lane group
HBM_CASES = [(64, 8, 2), (70, 8, 2), (33, 1, 3), (96, 5, 5), (45, 17, 2)]


def _self_loop_graph(seed: int, n: int, k: int, d: int):
    """`_graph` with padding slots (self index, weight 0) at every 4th slot
    from 3 and self loops (self index, the slot's non-zero weight) at every
    4th slot from 1."""
    X, idx, w = _graph(seed, n, k, d)
    rows = np.arange(n, dtype=np.int32)[:, None]
    idx[:, 1::4] = rows
    idx[:, 3::4] = rows
    w[:, 3::4] = 0.0
    return X, idx, w


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,d", HBM_CASES)
def test_hbm_layout_matches_jax_hbm_kernel(n, k, d, storage):
    """ops.ell_lap_matvec(layout="hbm") against the reference's staged
    kernel (TPU kernel 3, interpret mode, as tests/test_sparse_kernel.py
    runs it), both rounding X and the weights through the storage dtype."""
    X, idx, w = _self_loop_graph(5 * n + k + d, n, k, d)
    got = _port(X, idx, w, layout="hbm", storage_dtype=storage)
    want = np.asarray(jops.ell_lap_matvec(
        jnp.asarray(X), jnp.asarray(idx), jnp.asarray(w),
        impl="pallas-interpret", layout="hbm", block_rows=16, chunk=4,
        lane=8, storage_dtype=storage))
    assert jops.last_dispatch("ell_lap_matvec")["layout"] == "hbm"
    assert got.dtype == np.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * (np.abs(want).max() + 1))


def test_duplicate_columns_sum_and_padding_rows_zero():
    n, d = 16, 2
    X = np.random.default_rng(0).normal(size=(n, d)).astype(np.float32)
    idx = np.tile(np.arange(n, dtype=np.int32)[::-1][:, None], (1, 4))
    w = np.ones((n, 4), np.float32)
    idx[3], w[3] = 3, 0.0                   # an all-padding row
    got = _port(X, idx, w)
    want = np.asarray(jref.ell_lap_matvec_ref(jnp.asarray(X),
                                              jnp.asarray(idx),
                                              jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], 4.0 * (X[0] - X[n - 1]), rtol=1e-5)
    assert np.all(got[3] == 0.0)


def test_on_calibrated_graph():
    Y = np.random.default_rng(2).normal(size=(48, 6)).astype(np.float32)
    saff = jsparse_affinities(jnp.asarray(Y), k=10, perplexity=5.0,
                              model="ee")
    g = saff.graph
    X = np.random.default_rng(3).normal(size=(48, 2)).astype(np.float32)
    idx, w = np.array(g.indices), np.array(g.weights)
    want = np.asarray(jref.ell_lap_matvec_ref(jnp.asarray(X), g.indices,
                                              g.weights))
    np.testing.assert_allclose(_port(X, idx, w), want, rtol=TOL, atol=5e-6)


def test_cpu_tensors_take_the_oracle_and_never_the_kernel():
    X, idx, w = _graph(4, 32, 6, 2)
    before = dict(launch_counts)
    _port(X, idx, w)
    assert ops.last_dispatch("ell_lap_matvec")["reason"] == "cpu-tensor"
    assert launch_counts == before
    t = [torch.from_numpy(a) for a in (X, idx, w)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.ell_lap_matvec(*t, impl="kernel")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ell_lap_matvec_cuda(*t)
    with pytest.raises(ValueError, match="layout"):
        ops.ell_lap_matvec(*t, layout="smem")
    with pytest.raises(ValueError, match="impl"):
        ops.ell_lap_matvec(*t, impl="pallas")
