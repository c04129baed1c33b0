"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `cuda`; each test skips without a CUDA device (the kernels have no
CPU mode).  This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python3 -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances are those of the reference's kernel test
(tests/test_kernels_pairwise.py): la_x, lb_x at rtol 5e-5 with atol
5e-5 * (max|.| + 1), e_plus and s at rtol 1e-4, against the oracle in
float64 on the same storage-rounded inputs (in float32 the oracle's
sum(a) x_n - sum(a x_m) cancels digits that the kernel keeps), with the
Epanechnikov support-edge slack of `_epan_slack`.  The ELL kernels (both
layouts) are held at the tolerance of tests/test_sparse_kernel.py (rtol
5e-5, atol 5e-5 max|.|), against the float64 oracle on the same
storage-rounded inputs; the local-rows ELL kernel of the sharded backend
likewise, against the rows of its plain version.  The Barnes-Hut
cell-interaction kernel is held at
the tolerance of tests/test_farfield.py:192-195 (rtol 5e-5) with an
absolute part of 5e-5 max|.| plus 5e-5 sum_j |w b (x_n - c_j)| for the
entries that cancel, against the float64 oracle on the same storage-rounded
inputs, with the Epanechnikov support-edge slack.  The fused tree
evaluation (`bh_tree`) is held bit for bit to the per-batch kernel path
(the same sums in the same order), and to its plain version at rtol 1e-4.
The rest of the dense lineup (DiagH, nonlinear CG, L-BFGS, SD-) is held
fit for fit to its plain path at rtol 1e-4 (the reference's trace
tolerance, tests/test_api.py:92), at lambda values where no method
amplifies a last-bit difference; SparseSD's direction on the ELL kernel to
the same PCG solve on the plain ELL product, max |diff| / max |P| 1e-4.
Fits on the kernels resume from a checkpoint onto the uninterrupted
trajectory, and run with telemetry, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import farfield, ops, ref
from repro_torch.kernels import sparse_attractive
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


def _ell_graph(seed: int, n: int, k: int, d: int, device):
    """Random ELL graph with padding slots, an all-padding row (3) and a
    row of one repeated column (5)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    w = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    idx[:, 1::5] = np.arange(n)[:, None]
    w[:, 1::5] = 0.0
    idx[3], w[3] = 3, 0.0
    idx[5] = 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (X, idx, w))


# Row widths that reach every lane-group size S (4, 8, 16, 32 lanes a row),
# every bucket of slots a lane holds (1, 2, 4, 8) with its edges, and the
# passes of 256 slots of wider rows (300)
ELL_KS = (1, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 90, 229, 300)
# d = 1..4 (a template each; 2 and 4 gather one vector a row) and the
# generic d = 6 (four columns a block along gridDim.y)
ELL_DS = (1, 2, 3, 4, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vmem", "hbm"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_ell_kernel_matches_oracle(cuda_device, layout, storage):
    """Short and long rows (several to a warp, one, and several passes), every
    d template and the generic-d path, ragged N; one launch of the layout per
    call; padding rows exactly 0; a rerun is bit-identical."""
    name = f"ell_lap_matvec_{layout}"
    cases = [(300, 3, 2), (301, 24, 1), (257, 90, 3), (200, 40, 6)]
    cases += [(97 + 2 * k + d, k, d) for k in ELL_KS for d in ELL_DS]
    for n, k, d in cases:
        X, idx, w = _ell_graph(n + k, n, k, d, cuda_device)
        want = ref.ell_lap_matvec_ref(ops.to_storage(X, storage).double(),
                                      idx,
                                      ops.to_storage(w, storage).double())
        before = sparse_attractive.launch_counts[name]
        got = ops.ell_lap_matvec(X, idx, w, layout=layout,
                                 storage_dtype=storage)
        torch.cuda.synchronize()
        assert sparse_attractive.launch_counts[name] == before + 1
        assert ops.last_dispatch("ell_lap_matvec")["layout"] == layout
        err = (got.double() - want).abs()
        tol = TOL * want.abs().max() + TOL * want.abs()
        assert bool(torch.all(err <= tol)), (n, k, d, float(err.max()))
        assert bool(torch.all(got[3] == 0))
        again = ops.ell_lap_matvec(X, idx, w, layout=layout,
                                   storage_dtype=storage)
        assert torch.equal(got, again)


# Row widths of the staged gather's bit-equality test: every lane-group size
# S with the edges around it, the fits' forward (90) and reverse (229)
# widths, and phase check_ell's widest (386) in chip_smoke.py
STAGED_KS = (1, 4, 5, 8, 16, 17, 32, 64, 90, 128, 229, 256, 386)


def _self_loop_graph(seed: int, n: int, k: int, d: int, device):
    """`_ell_graph`'s cases (padding slots, an all-padding row 3, a row 5 of
    one repeated column) plus self loops: every 7th slot from slot 2 the
    row's own index with a non-zero weight, and row 4 nothing but its own
    index, all weights non-zero."""
    X, idx, w = _ell_graph(seed, n, k, d, device)
    rows = torch.arange(n, dtype=torch.int32, device=device)
    idx[:, 2::7] = rows[:, None]
    idx[4] = 4
    w[4] = w[4].abs() + 0.5
    return X, idx, w


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", STAGED_KS)
def test_cuda_staged_ell_equals_direct_bit_for_bit(cuda_device, k, storage):
    """The staged gather (layout hbm) gives the direct gather's bits: every d
    template and the generic d = 5, ragged N, and at d = 2 an N where each
    warp walks many rows through its ring; all-padding rows exactly 0."""
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_cuda

    cases = [(97 + 2 * k + d, d) for d in (1, 2, 3, 4, 5)] + [(20011, 2)]
    for n, d in cases:
        X, idx, w = _self_loop_graph(n + k + d, n, k, d, cuda_device)
        Xs, ws = ops.to_storage(X, storage), ops.to_storage(w, storage)
        staged = ell_lap_matvec_cuda(Xs, idx, ws, layout="hbm")
        direct = ell_lap_matvec_cuda(Xs, idx, ws, layout="vmem")
        torch.cuda.synchronize()
        assert torch.equal(staged, direct), (n, k, d, float(
            (staged - direct).abs().max()))
        assert bool(torch.all(staged[3] == 0))
        assert torch.equal(staged, ell_lap_matvec_cuda(Xs, idx, ws,
                                                       layout="hbm"))


@pytest.mark.cuda
def test_cuda_ell_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_cuda

    X, idx, w = _ell_graph(0, 64, 8, 2, cuda_device)
    with pytest.raises(TypeError, match="int32"):
        ell_lap_matvec_cuda(X, idx.long(), w)
    with pytest.raises(TypeError, match="storage dtype"):
        ell_lap_matvec_cuda(X, idx, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ell_lap_matvec_cuda(X, idx.T.contiguous().T, w)
    with pytest.raises(ValueError, match=r"\(64, k\)"):
        ell_lap_matvec_cuda(X, idx[:32], w[:32])
    # the staged gather's rings do not grow with k: a row of 100000 slots
    # runs, with the direct gather's bits
    g = torch.Generator(device=cuda_device).manual_seed(0)
    wide = torch.randint(0, 64, (64, 100000), dtype=torch.int32,
                         device=cuda_device, generator=g)
    ww = torch.rand(wide.shape, device=cuda_device, generator=g)
    assert torch.equal(ell_lap_matvec_cuda(X, wide, ww, layout="hbm"),
                       ell_lap_matvec_cuda(X, wide, ww, layout="vmem"))
    # a launch the library refuses raises and is not counted; nothing
    # falls back to the other layout or to the plain version
    class Refusing:
        def ell_lap_matvec_launch(self, *args):
            return 1                              # cudaErrorInvalidValue

    before = dict(sparse_attractive.launch_counts)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sparse_attractive, "_lib", Refusing)
        for layout in ("vmem", "hbm"):
            with pytest.raises(RuntimeError, match="launch failed"):
                ell_lap_matvec_cuda(X, idx, w, layout=layout)
    assert sparse_attractive.launch_counts == before


@pytest.mark.cuda
def test_cuda_sparse_fit_launches_follow_impl_and_layout(cuda_device):
    """The sparse objective's ELL products: kernel_impl="torch" launches no
    ELL kernel (CG operator and gradient alike); the default launches the
    default layout (`ops.ELL_DEFAULT_LAYOUT`) only;
    build_sparse_objective(ell_layout=) moves the CG operator to the other
    layout while the gradient stays on the default."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.embed.trainer import build_sparse_objective

    default = ops.ELL_DEFAULT_LAYOUT
    other, = (lay for lay in sparse_attractive.LAYOUTS if lay != default)
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(300, 8)).astype(np.float32)
    spec = EmbedSpec(kind="ee", lam=10.0, backend="sparse", perplexity=5.0,
                     n_neighbors=15, max_iters=2, tol=0.0)
    emb = Embedding(spec, device=cuda_device).fit(Y)
    sparse_attractive.reset_launch_counts()
    Embedding(spec.replace(kernel_impl="torch"), device=cuda_device).fit(
        None, X0=emb.X0_, saff=emb.affinities_)
    assert not any(sparse_attractive.launch_counts.values())
    sparse_attractive.reset_launch_counts()
    Embedding(spec, device=cuda_device).fit(None, X0=emb.X0_,
                                            saff=emb.affinities_)
    counts = dict(sparse_attractive.launch_counts)
    assert counts[f"ell_lap_matvec_{default}"] > 0
    assert counts[f"ell_lap_matvec_{other}"] == 0
    sparse_attractive.reset_launch_counts()
    obj, X0, _ = build_sparse_objective(
        spec, None, emb.X0_, saff=emb.affinities_, device=cuda_device,
        ell_layout=other)
    E, G = obj.energy_and_grad(X0, (spec.seed + 1, 0))
    assert sparse_attractive.launch_counts == {
        f"ell_lap_matvec_{default}": 2, f"ell_lap_matvec_{other}": 0,
        "ell_lap_matvec_local": 0}
    solve, P0 = obj.make_direction_solver()
    solve(P0, X0, G)
    assert sparse_attractive.launch_counts[f"ell_lap_matvec_{other}"] >= 2
    assert sparse_attractive.launch_counts[f"ell_lap_matvec_{default}"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_ell_local_kernel_matches_oracle(cuda_device, storage):
    """The local-rows kernel on the first, a middle and the last shard of a
    three-way row split, and a ragged shard (nb not a multiple of 8, row0
    not a multiple of any tile), at k = 24, d = 1..3, then the ragged shard
    at every row width of `ELL_KS` and every d of `ELL_DS`: one launch a
    call, the rows of the float64 plain version, padding rows exactly 0,
    reruns bit-identical."""
    name = "ell_lap_matvec_local"
    cases = [(d, 24, d, [(0, 100), (100, 100), (200, 100), (3, 77)])
             for d in (1, 2, 3)]
    cases += [(d + k, k, d, [(3, 77)]) for k in ELL_KS for d in ELL_DS]
    for seed, k, d, shards in cases:
        X, idx, w = _ell_graph(seed, 300, k, d, cuda_device)
        want_all = ref.ell_lap_matvec_ref(
            ops.to_storage(X, storage).double(), idx,
            ops.to_storage(w, storage).double())
        for row0, nb in shards:
            rows = slice(row0, row0 + nb)
            # a row view of the graph where it is 16-byte aligned (k row0 a
            # multiple of 4), else a shard of its own, as the sharded
            # backend holds it
            idx_l, w_l = idx[rows], w[rows]
            if k * row0 % 4:
                idx_l, w_l = idx_l.clone(), w_l.clone()
            before = sparse_attractive.launch_counts[name]
            got = ops.ell_lap_matvec_local(X, idx_l, w_l, row0,
                                           storage=storage)
            torch.cuda.synchronize()
            assert sparse_attractive.launch_counts[name] == before + 1
            assert ops.last_dispatch(name)["path"] == "kernel"
            want = want_all[rows]
            err = (got.double() - want).abs()
            tol = TOL * want.abs().max() + TOL * want.abs()
            assert bool(torch.all(err <= tol)), (k, d, row0,
                                                 float(err.max()))
            if row0 <= 3 < row0 + nb:
                assert bool(torch.all(got[3 - row0] == 0))
            again = ops.ell_lap_matvec_local(X, idx_l, w_l, row0,
                                             storage=storage)
            assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_ell_local_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.sparse_attractive import (
        ell_lap_matvec_local_cuda)

    X, idx, w = _ell_graph(0, 64, 8, 2, cuda_device)
    li, lw = idx[:16].clone(), w[:16].clone()
    with pytest.raises(ValueError, match=r"row0 = 49 must lie in"):
        ell_lap_matvec_local_cuda(X, li, lw, 49)
    with pytest.raises(ValueError, match="row0 = -1"):
        ell_lap_matvec_local_cuda(X, li, lw, -1)
    with pytest.raises(ValueError, match="1 to n_x = 8"):
        ell_lap_matvec_local_cuda(X[:8].clone(), li, lw, 0)
    with pytest.raises(ValueError, match="weights must match"):
        ell_lap_matvec_local_cuda(X, li, lw[:8].clone(), 0)
    with pytest.raises(TypeError, match="int32"):
        ell_lap_matvec_local_cuda(X, li.long(), lw, 0)
    with pytest.raises(ValueError, match="CUDA"):
        ell_lap_matvec_local_cuda(X.cpu(), li, lw, 0)


@pytest.mark.cuda
def test_cuda_sharded_fit_launches_the_local_kernel(cuda_device, tmp_path):
    """A one-rank NCCL group: the sparse-sharded fit runs its gradient and
    CG products on the local-rows kernel only, its trace is the
    single-device sparse fit's at rtol 1e-4 (mu_scale = 1e-3), and
    kernel_impl="torch" launches no kernel."""
    import datetime

    import torch.distributed as dist

    from repro_torch.api import Embedding, EmbedSpec

    rng = np.random.default_rng(0)
    Y = rng.normal(size=(300, 8)).astype(np.float32)
    spec = EmbedSpec(kind="tsne", lam=1.0, backend="sparse-sharded",
                     perplexity=5.0, n_neighbors=15, max_iters=3, tol=0.0,
                     mu_scale=1e-3)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        sparse_attractive.reset_launch_counts()
        emb = Embedding(spec, device=cuda_device).fit(Y)
        counts = dict(sparse_attractive.launch_counts)
        assert emb.backend_ == "sparse-sharded"
        assert counts["ell_lap_matvec_local"] > 0
        assert counts["ell_lap_matvec_vmem"] == counts["ell_lap_matvec_hbm"] == 0
        single = Embedding(spec.replace(backend="sparse"),
                           device=cuda_device).fit(None, X0=emb.X0_,
                                                   saff=emb.affinities_)
        np.testing.assert_allclose(emb.result_.energies,
                                   single.result_.energies, rtol=1e-4)
        sparse_attractive.reset_launch_counts()
        plain = Embedding(spec.replace(kernel_impl="torch"),
                          device=cuda_device).fit(Y)
        assert not any(sparse_attractive.launch_counts.values())
        np.testing.assert_allclose(plain.result_.energies,
                                   emb.result_.energies, rtol=1e-4)
    finally:
        dist.destroy_process_group()


def _bh_batch(seed: int, n: int, width: int, m: int, d: int, device):
    """A cell-interaction batch with zero-weight slots, an all-zero row (3)
    and a row of one repeated index (5); w holds occupancies 1..16."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    table = (1.5 * rng.normal(size=(m, d))).astype(np.float32)
    idx = rng.integers(0, m, size=(n, width)).astype(np.int32)
    w = np.where(rng.uniform(size=(n, width)) < 0.3, 0.0,
                 rng.integers(1, 17, size=(n, width))).astype(np.float32)
    w[3] = 0.0
    idx[5] = idx[5, 0]
    return (torch.from_numpy(a).to(device) for a in (X, idx, w, table))


def _bh_bound(X, idx, w, table, kind, storage, edge=1e-5):
    """(s, F) of the float64 oracle on the storage-rounded inputs and their
    bounds: 5e-5 (max|.| + |.|) plus 5e-5 times the magnitudes of the terms
    the kernel sums, sum_j |w b (x_n - c_j)| for F and sum_j |w sp| for s,
    and for epan, whose b = [t < 1] jumps at t = 1, the terms
    w |x_n - c_j| of the slots within `edge` of it."""
    X64 = ops.to_storage(X, storage).double()
    t64 = ops.to_storage(table, storage).double()
    w64 = w.double()
    s, F = ref.bh_interaction_ref(X64, idx.long(), w64, t64, kind)
    g = t64[idx.long()]
    diff = X64[:, None, :] - g
    tt = torch.sum(diff * diff, dim=-1)
    sp, b = ref.negative_pair_terms(kind, tt)
    mass = torch.einsum("nw,nwd->nd", (w64 * b).abs(), diff.abs())
    tol_F = TOL * F.abs().max() + TOL * F.abs() + TOL * mass
    if kind == "epan":
        near = ((tt - 1.0).abs() < edge) * w64
        tol_F = tol_F + torch.einsum("nw,nwd->nd", near, diff.abs())
    tol_s = TOL * s.abs().max() + TOL * s.abs() + TOL * (w64 * sp).abs().sum(-1)
    return s, F, tol_s, tol_F


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ref.KINDS)
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_bh_kernel_matches_oracle(cuda_device, kind, storage):
    """Widths of every lane group (1, 25, 96, 128), d = 1..3, a small table
    and a table of X's size; one launch per call; all-zero rows exactly 0; a
    column slice of a wider batch (as the tree's chunks are) gives the
    copy's result; a rerun is bit-identical."""
    for n, width, m, d in [(300, 1, 16, 2), (301, 25, 64, 1),
                           (257, 96, 4096, 2), (400, 128, 400, 3)]:
        X, idx, w, table = _bh_batch(n + width + d, n, width, m, d,
                                     cuda_device)
        s64, F64, tol_s, tol_F = _bh_bound(X, idx, w, table, kind, storage)
        before = farfield.launch_counts["bh_interaction"]
        s, F = ops.bh_interaction(X, idx, w, table, kind,
                                  storage_dtype=storage)
        torch.cuda.synchronize()
        assert farfield.launch_counts["bh_interaction"] == before + 1
        assert ops.last_dispatch("bh_interaction")["path"] == "kernel"
        assert s.dtype == F.dtype == torch.float32
        assert bool(torch.all((s.double() - s64).abs() <= tol_s)), kind
        assert bool(torch.all((F.double() - F64).abs() <= tol_F)), kind
        assert not bool(torch.all(F64.abs() <= tol_F))     # the bound has teeth
        assert float(s[3]) == 0.0 and bool(torch.all(F[3] == 0))
        again = ops.bh_interaction(X, idx, w, table, kind,
                                   storage_dtype=storage)
        assert torch.equal(s, again[0]) and torch.equal(F, again[1])
        if width > 1:
            half = width // 2
            sl = ops.bh_interaction(X, idx[:, :half], w[:, :half], table,
                                    kind, storage_dtype=storage)
            cp = ops.bh_interaction(X, idx[:, :half].contiguous(),
                                    w[:, :half].contiguous(), table, kind,
                                    storage_dtype=storage)
            assert torch.equal(sl[0], cp[0]) and torch.equal(sl[1], cp[1])


@pytest.mark.cuda
def test_cuda_bh_kernel_rejects_what_it_cannot_take(cuda_device):
    from repro_torch.kernels.farfield import bh_interaction_cuda

    X, idx, w, table = _bh_batch(0, 64, 8, 16, 2, cuda_device)
    with pytest.raises(TypeError, match="int32"):
        bh_interaction_cuda(X, idx.long(), w, table, "ee")
    with pytest.raises(TypeError, match="float32 slot weights"):
        bh_interaction_cuda(X, idx, w.bfloat16(), table, "ee")
    with pytest.raises(TypeError, match="storage dtype"):
        bh_interaction_cuda(X, idx, w, table.bfloat16(), "ee")
    with pytest.raises(ValueError, match="unit column stride"):
        bh_interaction_cuda(X, idx.T.contiguous().T, w, table, "ee")
    with pytest.raises(ValueError, match="d <= 4"):
        X5 = torch.zeros((64, 5), device=cuda_device)
        bh_interaction_cuda(X5, idx, w, torch.zeros((16, 5),
                                                    device=cuda_device), "ee")


def _tree_cloud(n, seed):
    """Four clusters of uneven occupancy, float32 (as the CPU tests'
    `_cloud`)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 2)) * 2.0
    return (centers[np.arange(n) % 4]
            + rng.normal(size=(n, 2)) * 0.4).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("theta", [0.5, 1.0, 0.34])
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ref.KINDS)
def test_cuda_bh_tree_matches_per_batch_kernel(cuda_device, kind, storage,
                                               theta):
    """One launch of the fused kernel gives every batch's s row and the
    summed F of the per-batch kernel path (`bh_rows` over the materialised
    batches, chunk by chunk) bit for bit, at the default cap and at cap = 2
    (most cells spill into the residual); `tree_repulsion` takes it and
    equals `_tree_repulsion_batched` bit for bit; it is within rtol 1e-4 of
    its plain version."""
    from repro_torch.sparse import farfield as ff

    X = torch.from_numpy(_tree_cloud(3000, seed=11)).to(cuda_device)
    for cap in (0, 2):
        plan = ff.make_grid_plan(3000, theta=theta, cap=cap)
        grid = ff._grid_state(X, plan)
        before = dict(farfield.launch_counts)
        s_rows, F = ops.bh_tree(grid, kind, storage_dtype=storage)
        torch.cuda.synchronize()
        assert farfield.launch_counts["bh_tree"] == before["bh_tree"] + 1
        assert farfield.launch_counts["bh_interaction"] == before[
            "bh_interaction"]
        assert ops.last_dispatch("bh_tree")["path"] == "kernel"
        batches = ff._interaction_batches(X, plan)
        assert s_rows.shape == (len(batches), 3000)
        F_want = torch.zeros_like(F)
        for row, b in zip(s_rows, batches):
            s_b, F_b = ff._apply_chunked(X, b, kind, plan.chunk,
                                         {"storage_dtype": storage})
            assert torch.equal(row, s_b), (b.tag, cap)
            F_want = F_want + F_b
        assert torch.equal(F, F_want), cap
        if cap == 2:
            assert float(batches[-1].w.sum()) > 0
        s, F_tree = ff.tree_repulsion(X, plan, kind, storage_dtype=storage)
        s_b, F_b = ff._tree_repulsion_batched(X, plan, kind,
                                              storage_dtype=storage)
        assert torch.equal(s, s_b) and torch.equal(F_tree, F_b)
        ps, pF = ops.bh_tree(grid, kind, storage_dtype=storage, impl="torch")
        np.testing.assert_allclose(s_rows.sum(1).cpu().numpy(),
                                   ps.sum(1).cpu().numpy(), rtol=1e-4,
                                   atol=1e-30)
        if kind != "epan":   # epan's b = [t < 1] may flip at t = 1 +- ulp
            scale = float(pF.abs().max())
            np.testing.assert_allclose(F.cpu().numpy(), pF.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5 * scale)
        again = ops.bh_tree(grid, kind, storage_dtype=storage)
        assert torch.equal(again[0], s_rows) and torch.equal(again[1], F)


@pytest.mark.cuda
def test_cuda_bh_tree_rejects_what_it_cannot_take(cuda_device):
    import dataclasses

    from repro_torch.kernels.farfield import bh_tree_cuda
    from repro_torch.sparse import farfield as ff

    X = torch.from_numpy(_tree_cloud(256, seed=12)).to(cuda_device)
    grid = ff._grid_state(X, ff.make_grid_plan(256))
    with pytest.raises(ValueError, match="d = 2 only"):
        bh_tree_cuda(dataclasses.replace(
            grid, Xs=torch.zeros((256, 3), device=cuda_device)), "ee")
    with pytest.raises(TypeError, match="storage dtype"):
        bh_tree_cuda(dataclasses.replace(grid, res_com=grid.res_com.bfloat16()),
                     "ee")
    with pytest.raises(ValueError, match="CUDA tensors"):
        bh_tree_cuda(ff._grid_state(X.cpu(), ff.make_grid_plan(256)), "ee")
    with pytest.raises(ValueError, match="exhaustive"):
        bh_tree_cuda(dataclasses.replace(grid, r=0), "ee")
    with pytest.raises(ValueError, match="kind"):
        bh_tree_cuda(grid, "nope")
    with pytest.raises(ValueError, match="CUDA"):
        ops.bh_tree(ff._grid_state(X.cpu(), ff.make_grid_plan(256)), "ee",
                    impl="kernel")


@pytest.mark.cuda
def test_cuda_tree_fit_launches_follow_impl(cuda_device):
    """A tree fit launches the fused kernel once an evaluation and the
    per-batch kernel never; kernel_impl="torch" launches no kernel at all;
    a rerun is bit-identical, and so is a rerun through the per-batch kernel
    path (`_tree_repulsion_batched`, one launch a chunk)."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.sparse import farfield as ff
    from repro_torch.sparse import make_grid_plan

    rng = np.random.default_rng(0)
    Y = rng.normal(size=(300, 8)).astype(np.float32)
    spec = EmbedSpec(kind="tsne", lam=1.0, backend="tree", perplexity=5.0,
                     n_neighbors=15, max_iters=3, tol=0.0)
    farfield.reset_launch_counts()
    emb = Embedding(spec, device=cuda_device).fit(Y)
    evals = int(emb.result_.n_fevals[-1])
    assert farfield.launch_counts == {"bh_interaction": 0, "bh_tree": evals}
    farfield.reset_launch_counts()
    sparse_attractive.reset_launch_counts()
    plain = Embedding(spec.replace(kernel_impl="torch"), device=cuda_device
                      ).fit(None, X0=emb.X0_, saff=emb.affinities_)
    assert not any(farfield.launch_counts.values())
    assert not any(sparse_attractive.launch_counts.values())
    np.testing.assert_allclose(plain.result_.energies, emb.result_.energies,
                               rtol=1e-4)
    again = Embedding(spec, device=cuda_device).fit(None, X0=emb.X0_,
                                                    saff=emb.affinities_)
    assert torch.equal(again.embedding_, emb.embedding_)
    fused = ff.tree_repulsion
    ff.tree_repulsion = ff._tree_repulsion_batched
    try:
        farfield.reset_launch_counts()
        batched = Embedding(spec, device=cuda_device).fit(
            None, X0=emb.X0_, saff=emb.affinities_)
    finally:
        ff.tree_repulsion = fused
    plan = make_grid_plan(300)
    near_width = (2 * plan.r + 1) ** 2 * plan.cap
    near_chunks = (near_width + plan.chunk - 1) // plan.chunk
    per_eval = (plan.depth - plan.l1 + 1) + near_chunks + 1   # + residual
    assert farfield.launch_counts == {"bh_interaction": per_eval * evals,
                                      "bh_tree": 0}
    assert np.array_equal(batched.result_.energies, emb.result_.energies)
    assert torch.equal(batched.embedding_, emb.embedding_)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy,kind,lam", [
    ("diag", "ee", 1.0), ("diag", "tsne", 1.0), ("cg", "ee", 1.0),
    ("cg", "tsne", 1.0), ("lbfgs", "ee", 10.0), ("lbfgs", "tsne", 1.0),
    ("sd-", "ee", 10.0), ("sd-", "tsne", 1.0)])
def test_cuda_lineup_fit_matches_plain_path(cuda_device, strategy, kind,
                                            lam):
    """A small dense fit of each new method: one pairwise launch an energy
    evaluation, and the plain path's trace (which launches nothing)."""
    from repro_torch.api import Embedding, EmbedSpec

    Y = np.random.default_rng(1).normal(size=(300, 8)).astype(np.float32)
    spec = EmbedSpec(kind=kind, strategy=strategy, backend="dense", lam=lam,
                     perplexity=10.0, max_iters=3, tol=0.0)
    launch_counts["pairwise_terms"] = 0
    emb = Embedding(spec, device=cuda_device).fit(Y)
    res = emb.result_
    assert launch_counts["pairwise_terms"] == int(res.n_fevals[-1])
    assert np.all(np.isfinite(res.energies))
    assert np.all(np.diff(res.energies) <= 0)
    launch_counts["pairwise_terms"] = 0
    plain = Embedding(spec.replace(kernel_impl="torch"),
                      device=cuda_device).fit(None, X0=emb.X0_,
                                              aff=emb.affinities_)
    assert launch_counts["pairwise_terms"] == 0
    np.testing.assert_allclose(res.energies, plain.result_.energies,
                               rtol=1e-4)
    np.testing.assert_array_equal(res.n_fevals, plain.result_.n_fevals)


@pytest.mark.cuda
def test_cuda_sparsesd_direction_matches_plain_ell(cuda_device):
    """SparseSD (k = 7, dense affinities) launches the default ELL layout
    in its PCG, and its direction is the same solve on the plain ELL
    product."""
    from repro_torch.core import make_affinities, make_strategy
    from repro_torch.core.objectives import energy_and_grad
    from repro_torch.sparse.graph import NeighborGraph
    from repro_torch.sparse.linalg import pcg, sym_lap_matvec

    rng = np.random.default_rng(2)
    Y = torch.from_numpy(rng.normal(size=(500, 10)).astype(np.float32))
    aff = make_affinities(Y.to(cuda_device), 10.0, model="ee")
    X = torch.from_numpy(rng.normal(size=(500, 2)).astype(np.float32)
                         ).to(cuda_device)
    _, G = energy_and_grad(X, aff, "ee", 10.0, impl="torch")
    strategy = make_strategy("sparsesd", k=7)
    state = strategy.init(X, aff, "ee", 10.0)
    sparse_attractive.reset_launch_counts()
    P, _ = strategy.direction(state, X, G, aff, "ee", 10.0)
    counts = sparse_attractive.launch_counts
    assert counts[f"ell_lap_matvec_{ops.ELL_DEFAULT_LAYOUT}"] >= 2
    g = NeighborGraph(state["indices"], state["weights"])
    rev = NeighborGraph(state["rev_indices"], state["rev_weights"])
    sparse_attractive.reset_launch_counts()
    want = pcg(lambda V: 4.0 * sym_lap_matvec(g, V, rev=rev, impl="torch")
               + state["shift"][:, None] * V, -G, state["prev_P"],
               inv_diag=state["inv_diag"], tol=strategy.cg_tol,
               maxiter=strategy.cg_maxiter).x
    assert not any(sparse_attractive.launch_counts.values())
    assert float((P - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("backend,kind", [("dense", "ee"), ("sparse", "tsne"),
                                          ("tree", "ee")])
def test_cuda_resume_and_telemetry_are_bit_identical(cuda_device, tmp_path,
                                                     backend, kind):
    """On the kernels (pairwise, ELL, bh_tree): a fit stopped and resumed by
    a fresh estimator replays the uninterrupted one, and a fit with
    telemetry is the fit without it, bit for bit; the iteration records
    carry the card's memory counters."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.data import mnist_like

    Y, _ = mnist_like(n=400, dim=20, seed=0)
    spec = EmbedSpec(kind=kind, lam=1.0 if kind == "tsne" else 50.0,
                     backend=backend, perplexity=8.0, n_neighbors=24,
                     max_iters=6, tol=0.0)
    full = Embedding(spec, device=cuda_device).fit(Y)
    on = Embedding(spec, device=cuda_device).fit(Y, telemetry=True)
    np.testing.assert_array_equal(on.result_.energies, full.result_.energies)
    assert torch.equal(on.embedding_, full.embedding_)
    assert on.telemetry_.recorder.records[-1].extras["mem_peak_bytes"] > 0
    part = spec.replace(max_iters=3, checkpoint_dir=str(tmp_path / "ck"))
    Embedding(part, device=cuda_device).fit(Y)
    res = Embedding(part, device=cuda_device).resume(Y, max_iters=6)
    assert res.result_.resumed_from == 3
    np.testing.assert_array_equal(res.result_.energies[1:],
                                  full.result_.energies[4:])
    assert torch.equal(res.embedding_, full.embedding_)


@pytest.mark.parametrize("kind", ref.KINDS)
@pytest.mark.cuda
def test_dense_mesh_tile_on_the_card_matches_the_cpu(cuda_device, kind):
    """The dense-mesh backend's plain-torch tile (embed/distributed.py, no
    kernel) on a rectangular 256 x 512 diagonal tile with unit W-: the
    card's result against the CPU's at rtol 1e-5 (the products with an
    absolute part of 1e-5 max|.|)."""
    from repro_torch.embed.distributed import _tile_terms_local
    rng = np.random.default_rng(5)
    args = [rng.normal(size=(256, 2)).astype(np.float32),
            rng.normal(size=(512, 2)).astype(np.float32),
            np.abs(rng.normal(size=(256, 512))).astype(np.float32)]
    cpu = _tile_terms_local(kind, *(torch.tensor(a) for a in args), None,
                            True)
    dev = _tile_terms_local(kind, *(torch.tensor(a, device=cuda_device)
                                    for a in args), None, True)
    for got, want in zip(dev, cpu):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


# -- launch shapes: every autotune candidate gives the fixed shape's bits -------


def _terms(t):
    return (t.la_x, t.lb_x, t.e_plus, t.s)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_pairwise_candidates_bit_equal_to_fixed(cuda_device, storage):
    """Every pairwise candidate (rows a block x staged tile) gives the fixed
    shape's la_x, lb_x, e_plus and s bit for bit: aligned and ragged N, one
    tile and several, d = 2, 3 and the generic d = 6."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.pairwise import pairwise_terms_cuda

    for n, d in [(256, 2), (301, 3), (3000, 2), (200, 6)]:
        X, Wa, Wb = (ops.to_storage(torch.from_numpy(a).to(cuda_device),
                                    storage) for a in _problem(n, n, d))
        for kind in ("ee", "tsne"):
            fixed = _terms(pairwise_terms_cuda(X, Wa, Wb, kind))
            for cfg in autotune.pairwise_candidates(d=d):
                got = _terms(pairwise_terms_cuda(
                    X, Wa, Wb, kind, block_rows=cfg.block_rows,
                    block_cols=cfg.block_cols))
                assert all(torch.equal(a, b) for a, b in zip(got, fixed)), (
                    n, d, kind, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["vmem", "hbm", "local"])
def test_cuda_ell_candidates_bit_equal_to_fixed(cuda_device, layout,
                                                storage):
    """Every candidate of the direct gather (threads a block x P), the
    staged gather (warps x span) and the local-rows kernel gives the fixed
    shape's bits, at every lane-group size and slot bucket."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.sparse_attractive import (
        ell_lap_matvec_cuda, ell_lap_matvec_local_cuda)

    for k in ELL_KS:
        for d in (1, 2, 3, 6):
            X, idx, w = _ell_graph(k + d, 1000, k, d, cuda_device)
            Xs, ws = ops.to_storage(X, storage), ops.to_storage(w, storage)
            if layout == "local":
                def run(**shape):
                    return ell_lap_matvec_local_cuda(
                        Xs, idx[300:700].clone(), ws[300:700].clone(), 300,
                        **shape)
            else:
                def run(**shape):
                    return ell_lap_matvec_cuda(Xs, idx, ws, layout=layout,
                                               **shape)
            fixed = run()
            lay = "hbm" if layout == "hbm" else "vmem"
            for cfg in autotune.ell_candidates(k=k, layouts=[lay]):
                got = run(block_rows=cfg.block_rows, chunk=cfg.chunk)
                assert torch.equal(got, fixed), (k, d, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_cuda_bh_candidates_bit_equal_to_fixed(cuda_device, storage):
    """The per-batch cell interaction at every block size, and the fused
    tree kernel at every rows a block, give the fixed shape's bits."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.farfield import (bh_interaction_cuda,
                                              bh_tree_cuda)
    from repro_torch.sparse import farfield as ff

    for n, width, m, d in [(300, 1, 16, 2), (301, 25, 64, 1),
                           (1000, 96, 256, 2), (999, 128, 999, 3)]:
        X, idx, w, table = _bh_batch(width, n, width, m, d, cuda_device)
        Xs, tab = ops.to_storage(X, storage), ops.to_storage(table, storage)
        for kind in ("ee", "tsne"):
            fixed = bh_interaction_cuda(Xs, idx, w, tab, kind)
            for cfg in autotune.bh_candidates(width=width):
                got = bh_interaction_cuda(Xs, idx, w, tab, kind,
                                          block_rows=cfg.block_rows)
                assert all(torch.equal(a, b) for a, b in zip(got, fixed)), (
                    n, width, kind, cfg)
    X = ops.to_storage(torch.from_numpy(_tree_cloud(3000, seed=5))
                       .to(cuda_device), storage)
    grid = ff._grid_state(X, ff.make_grid_plan(3000, theta=0.5))
    for kind in ("ee", "tsne"):
        fixed = bh_tree_cuda(grid, kind)
        for cfg in autotune.bh_tree_candidates():
            got = bh_tree_cuda(grid, kind, block_rows=cfg.block_rows)
            assert all(torch.equal(a, b) for a, b in zip(got, fixed)), (
                kind, cfg)


@pytest.mark.cuda
def test_cuda_out_of_range_launch_shapes_raise(cuda_device):
    """A shape the entry point does not take returns cudaErrorInvalidValue,
    and the wrapper raises: no fallback, no count."""
    from repro_torch.kernels import pairwise
    from repro_torch.kernels.farfield import bh_interaction_cuda, bh_tree_cuda
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_cuda
    from repro_torch.sparse import farfield as ff

    X, Wa, Wb = (torch.from_numpy(a).to(cuda_device)
                 for a in _problem(0, 64, 2))
    before = dict(launch_counts)
    for shape in ({"block_rows": 17}, {"block_cols": 100},
                  {"block_cols": 128 * 100}):
        with pytest.raises(RuntimeError, match="launch failed"):
            pairwise.pairwise_terms_cuda(X, Wa, Wb, "ee", **shape)
    assert launch_counts == before
    X, idx, w = _ell_graph(0, 64, 90, 2, cuda_device)
    before = dict(sparse_attractive.launch_counts)
    for layout, shape in (("vmem", {"chunk": 3}), ("vmem", {"block_rows": 17}),
                          ("hbm", {"block_rows": 33, "chunk": 8}),
                          ("hbm", {"block_rows": 16 * 8, "chunk": 8})):
        with pytest.raises(RuntimeError, match="launch failed"):
            ell_lap_matvec_cuda(X, idx, w, layout=layout, **shape)
    X4, idx4, w4 = _ell_graph(0, 64, 4, 2, cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        ell_lap_matvec_cuda(X4, idx4, w4, chunk=2)      # S = 4 has P = 1
    assert sparse_attractive.launch_counts == before
    X, idx, w, table = _bh_batch(0, 64, 25, 16, 2, cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        bh_interaction_cuda(X, idx, w, table, "ee", block_rows=3)
    grid = ff._grid_state(torch.from_numpy(_tree_cloud(256, 0))
                          .to(cuda_device), ff.make_grid_plan(256))
    with pytest.raises(RuntimeError, match="launch failed"):
        bh_tree_cuda(grid, "ee", block_rows=17)


@pytest.mark.cuda
def test_cuda_dispatch_autotunes_and_counts_search_launches_apart(
        cuda_device, monkeypatch):
    """On CUDA tensors the dispatch searches once a key (its launches apart
    from launch_counts), hits after, and gives the fixed shape's bits."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_cuda

    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_cache()
    X, idx, w = _ell_graph(3, 4096, 90, 2, cuda_device)
    before = dict(sparse_attractive.launch_counts)
    searches = autotune.n_searches
    out = ops.ell_lap_matvec(X, idx, w)
    rec = dict(ops.last_dispatch("ell_lap_matvec"))
    assert rec["autotuned"] and not rec["cache_hit"]
    assert autotune.n_searches == searches + 1
    assert autotune.search_launches.get("ell_lap_matvec_vmem", 0) >= 6
    assert (sparse_attractive.launch_counts["ell_lap_matvec_vmem"]
            == before["ell_lap_matvec_vmem"] + 1)
    again = ops.ell_lap_matvec(X, idx, w)
    assert ops.last_dispatch("ell_lap_matvec")["cache_hit"]
    assert torch.equal(out, again)
    assert torch.equal(out, ell_lap_matvec_cuda(X, idx, w))
    autotune.clear_cache()
