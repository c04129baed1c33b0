"""The CUDA pairwise kernel against its plain PyTorch version, on the GPU.

Marked `cuda`; each test skips without a CUDA device (the kernel has no CPU
mode).  This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python3 -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances are those of the reference's kernel test
(tests/test_kernels_pairwise.py): la_x, lb_x at rtol 5e-5 with atol
5e-5 * (max|.| + 1), e_plus and s at rtol 1e-4, against the oracle in
float64 on the same storage-rounded inputs (in float32 the oracle's
sum(a) x_n - sum(a x_m) cancels digits that the kernel keeps), with the
Epanechnikov support-edge slack of `_epan_slack`.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.pairwise import launch_counts

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


def _epan_slack(X64, Wb64, edge=1e-5):
    """epan's b = Wb [t < 1] jumps at t = 1: a pair whose t lies within
    float32 rounding of 1 can fall on either side in two correct float32
    evaluations, moving lb_x by Wb |x_n - x_m|.  Their sum over the pairs
    with |t - 1| < edge is added to lb_x's bound."""
    near = ((torch.cdist(X64, X64) ** 2 - 1.0).abs() < edge) * Wb64
    return torch.stack([torch.sum(near * (X64[:, None, k] - X64[None, :, k]).abs(),
                                  dim=1) for k in range(X64.shape[1])], 1).cpu()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ref.KINDS)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_kernel_matches_oracle(cuda_device, kind, storage):
    """Aligned and ragged N, d = 2, 3 and the generic-d path; the dispatch
    launches the kernel once per call; a rerun is bit-identical."""
    for n, d in [(256, 2), (301, 3), (200, 6)]:
        X, Wa, Wb = (torch.from_numpy(a).to(cuda_device)
                     for a in _problem(n, n, d))
        X64, Wa64, Wb64 = (ops.to_storage(t, storage).double()
                           for t in (X, Wa, Wb))
        want = ref.pairwise_terms_ref(X64, Wa64, Wb64, kind)
        slack = _epan_slack(X64, Wb64) if kind == "epan" else 0.0
        before = launch_counts["pairwise_terms"]
        got = ops.pairwise_terms(X, Wa, Wb, kind, storage_dtype=storage)
        assert launch_counts["pairwise_terms"] == before + 1
        assert ops.last_dispatch("pairwise_terms")["path"] == "kernel"
        for name in ("la_x", "lb_x"):
            g = getattr(got, name).double().cpu().numpy()
            w = getattr(want, name).cpu().numpy()
            tol = TOL * (np.abs(w).max() + 1) + TOL * np.abs(w)
            if name == "lb_x":
                tol = tol + np.asarray(slack)
            assert np.all(np.abs(g - w) <= tol), (name, np.abs(g - w).max())
        for name in ("e_plus", "s"):
            np.testing.assert_allclose(float(getattr(got, name)),
                                       float(getattr(want, name)), rtol=1e-4)
        again = ops.pairwise_terms(X, Wa, Wb, kind, storage_dtype=storage)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.pairwise import pairwise_terms_cuda

    X, Wa, Wb = (torch.from_numpy(a).to(cuda_device)
                 for a in _problem(0, 64, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pairwise_terms_cuda(X.double(), Wa.double(), Wb.double(), "ee")
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_terms_cuda(X, Wa.T, Wb, "ee")
    with pytest.raises(ValueError, match=r"\(64, 64\)"):
        pairwise_terms_cuda(X, Wa[:32], Wb, "ee")
