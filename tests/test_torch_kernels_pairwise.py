"""The port's pairwise terms (repro_torch.kernels) against the JAX reference.

On the CPU `repro_torch.kernels.ops.pairwise_terms` runs its plain PyTorch
oracle; it is held against the JAX oracle (`repro.kernels.ref`) and the
JAX Pallas kernel in interpret mode, on the same numpy inputs, at the
tolerances of the reference's own kernel test (tests/test_kernels_pairwise.py:
la_x, lb_x at rtol 5e-5 with atol 5e-5 * (max|.| + 1); e_plus and s at
rtol 1e-4).  The CUDA kernel itself runs only on a GPU:
tests/test_torch_kernels_cuda.py.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pairwise import launch_counts, pairwise_terms_cuda

KINDS = ref.KINDS
TOL = 5e-5


def _problem(seed: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Ws = []
    for _ in range(2):
        W = np.abs(rng.normal(size=(n, n))).astype(np.float32)
        W = 0.5 * (W + W.T)
        np.fill_diagonal(W, 0.0)
        Ws.append(W)
    return X, Ws[0], Ws[1]


def _assert_terms_close(got, want):
    for name in ("la_x", "lb_x"):
        g = np.asarray(getattr(got, name))
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(g, w, rtol=TOL,
                                   atol=TOL * (np.abs(w).max() + 1))
    for name in ("e_plus", "s"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4)


def _port(X, Wa, Wb, kind, **kw):
    return ops.pairwise_terms(torch.from_numpy(X), torch.from_numpy(Wa),
                              torch.from_numpy(Wb), kind, **kw)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,d", [(64, 2), (130, 2), (33, 3), (96, 3)])
def test_oracle_matches_jax_ref(kind, n, d):
    X, Wa, Wb = _problem(n + d, n, d)
    want = jref.pairwise_terms_ref(jnp.asarray(X), jnp.asarray(Wa),
                                   jnp.asarray(Wb), kind)
    _assert_terms_close(_port(X, Wa, Wb, kind), want)
    assert ops.last_dispatch("pairwise_terms") == {
        "path": "torch", "reason": "cpu-tensor", "storage": "float32"}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(72, 2), (45, 3)])
def test_port_matches_jax_pallas_interpret(kind, storage, n, d):
    """Ragged N against the Pallas kernel run in interpret mode (its zero
    padding of N and lane padding of d), in both storage dtypes."""
    X, Wa, Wb = _problem(7 * n + d, n, d)
    want = jops.pairwise_terms(jnp.asarray(X), jnp.asarray(Wa),
                               jnp.asarray(Wb), kind,
                               impl="pallas-interpret", lane=8,
                               block_rows=16, block_cols=16,
                               storage_dtype=storage)
    _assert_terms_close(_port(X, Wa, Wb, kind, storage_dtype=storage), want)
    assert ops.last_dispatch("pairwise_terms")["storage"] == storage


def test_bf16_storage_rounds_like_the_reference():
    """bfloat16 storage rounds X, Wa and Wb exactly as `_maybe_bf16`: the
    port's oracle on bf16-rounded inputs equals its f32 oracle on the same
    inputs pre-rounded."""
    X, Wa, Wb = _problem(3, 40, 2)
    rounded = [torch.from_numpy(a).to(torch.bfloat16).float()
               for a in (X, Wa, Wb)]
    got = _port(X, Wa, Wb, "tsne", storage_dtype="bfloat16")
    want = ops.pairwise_terms(*rounded, "tsne")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", KINDS)
def test_negative_pair_terms_match_jax(kind):
    t = np.random.default_rng(0).uniform(0, 3, size=(50,)).astype(np.float32)
    got = ref.negative_pair_terms(kind, torch.from_numpy(t))
    want = jref.negative_pair_terms(kind, jnp.asarray(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_dispatch_records_forced_torch_path():
    X, Wa, Wb = _problem(1, 20, 2)
    _port(X, Wa, Wb, "ee", impl="torch")
    assert ops.last_dispatch("pairwise_terms")["reason"] == "forced-off"
    assert "pairwise_terms" in ops.last_dispatch()


def test_kernel_wrapper_refuses_cpu_tensors():
    X, Wa, Wb = (torch.from_numpy(a) for a in _problem(2, 16, 2))
    before = launch_counts["pairwise_terms"]
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_terms_cuda(X, Wa, Wb, "ee")
    with pytest.raises(ValueError, match="CUDA"):
        ops.pairwise_terms(X, Wa, Wb, "ee", impl="kernel")
    assert launch_counts["pairwise_terms"] == before


def test_dispatch_rejects_unknown_knobs():
    X, Wa, Wb = _problem(2, 8, 2)
    with pytest.raises(ValueError, match="kind"):
        _port(X, Wa, Wb, "sne")
    with pytest.raises(ValueError, match="impl"):
        _port(X, Wa, Wb, "ee", impl="pallas")
    with pytest.raises(ValueError, match="storage_dtype"):
        _port(X, Wa, Wb, "ee", storage_dtype="float16")


def test_importing_the_port_builds_nothing():
    """Every module of repro_torch imports with no CUDA compiler in reach,
    and no kernel is built or loaded by the import."""
    code = (
        "import importlib, pkgutil, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import _build, pairwise\n"
        "assert _build.BUILD_INFO == {} and _build._LIBS == {}\n"
        "assert pairwise._LIB is None\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
