"""The mesh, sparse neighbour-graph and Barnes-Hut tree backends of the
engine.

Port of `build_dense_mesh_objective`, `build_sparse_objective`,
`build_tree_objective` and their objectives from `repro/embed/trainer.py`
(not the deprecated `EmbedConfig` / `DistributedEmbedding` / `FitResult`
shims).  The dense mesh backend 2-D-shards the N x N affinities over the
ranks of a `launch.mesh.Mesh` and solves the spectral direction
block-Jacobi (embed/distributed.py).  The sparse and tree backends keep
k-NN affinities in ELL storage and solve matrix-free, with no (N, N) array
anywhere.  The sparse backend's repulsion is negative-sampled,
O(N (k + m) d) an iteration; normalized models (ssne/tsne) run through the
sampled ratio estimator of the partition function, with a streaming (EMA)
estimate threaded through the objective.  The tree backend's repulsion is
the deterministic grid far field of sparse/farfield.py, O(N log N) an
iteration, 2-D only.

Strategies: the spectral direction ``sd`` (on the sparse and tree backends
Jacobi-PCG on B = 4 L(W+) + mu I, warm-started from the previous direction;
on the dense mesh the block-Jacobi Cholesky solve) and its diagonal
degenerations ``fp`` (the Jacobi diagonal 4 D+ + mu applied directly) and
``gd`` (B = I).

The sparse objectives are stochastic: the engine hands them one draw key
(seed, it) an iteration, and `shift_source(seed, it)` turns it into that
iteration's negative shifts (by default `core.objectives.draw_shifts`; a
test passes the reference's draws instead).  A line search reuses its
iteration's shifts, so it descends one fixed surrogate.  The tree objective
draws nothing: the engine's deterministic path reuses the accepted energy.

The row-sharded variant (``sharded=True``, the ``sparse-sharded`` backend)
splits the graph's rows over the ranks of a `launch.mesh.Mesh`
(sparse/sharding.py).  Every rank builds the graph and the spectral start
from the whole data with the same seeds, as the single-device path does, and
runs the same host loop on replicated vectors; only the energy, gradient and
CG products are sharded.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.core.affinities import make_affinities
from repro_torch.core.laplacian import degree
from repro_torch.core.objectives import (attractive_weights, draw_shifts,
                                         energy_and_grad_sparse,
                                         is_normalized)
from repro_torch.core.spectral_init import laplacian_eigenmaps
from repro_torch.core.strategies import _jitter
from repro_torch.embed.distributed import (EmbedMeshSpec, _layout,
                                           default_mesh_spec,
                                           make_block_jacobi_setup,
                                           make_block_jacobi_solve,
                                           make_distributed_energy_grad,
                                           replicate, shard_pairwise,
                                           shard_rows)
from repro_torch.embed.engine import make_loop_config  # noqa: F401  (the
# reference's trainer defines it; the port's lives in the engine)
from repro_torch.obs import span
from repro_torch.sparse import (energy_and_grad_tree, make_grid_plan,
                                make_sd_operator, make_sharded_energy_grad,
                                make_sharded_sd_operator, pcg,
                                shard_sparse_affinities, sparse_affinities,
                                sparse_laplacian_eigenmaps, to_dense,
                                tree_diagnostics, validate_sparse_mesh)
from repro_torch.sparse.sharding import assert_replicated, max_over_ranks

#: N up to which the sparse spectral start uses the dense eigh
DENSE_INIT_N = 2048


class _RankHooks:
    """The engine's hooks for an objective whose ranks each run the fit
    loop on the same replicated state (`self._mesh`, a `launch.mesh.Mesh`
    or None; `self._X0` names the device): the time budget reads the
    slowest rank's clock (`agree_elapsed`) and rank 0 writes the
    checkpoints (`share_checkpoint`)."""

    _mesh = None

    def share_checkpoint(self, write: Callable[[], object]) -> None:
        """The engine's save on a mesh of several ranks: rank 0 writes, and
        one all_reduce (a barrier) tells every rank whether it did, so that
        every rank returns once the step is on disk or raises if it is not.
        Every rank holds the same replicated payload."""
        if self._mesh is None or self._mesh.size == 1:
            write()
            return
        err = None
        if self._mesh.rank == 0:
            try:
                write()
            except Exception as e:          # re-raised below, every rank
                err = e
        if max_over_ranks(self._mesh, float(err is not None),
                          self._X0.device) > 0:
            raise RuntimeError("rank 0 failed to write the checkpoint"
                               ) from err

    def agree_elapsed(self, seconds: float) -> float:
        """The seconds the engine's time budget reads: this rank's own, or
        under a mesh of several ranks the slowest rank's, so that every rank
        stops on the same iteration."""
        if self._mesh is None or self._mesh.size == 1:
            return seconds
        return max_over_ranks(self._mesh, seconds, self._X0.device)


class _SparseObjective(_RankHooks):
    """Sparse backend over (eg, e_only, solve) closures.  Stochastic: one
    draw of negatives an iteration, from `shift_source(*key)` (cached for
    the line-search trials that share the key).  `solve(G, P0) -> (P,
    diag)` may warm-start from the previous direction P0 (PCG does; the
    engine checkpoints P0 as its solver state); `diag` holds the solver's
    counters, read back by `diagnostics()` only when a callback or
    telemetry listens.  Under a `mesh` (the sharded backend) the ranks
    agree through `_RankHooks`."""

    stochastic = True

    def __init__(self, eg, e_only, solve, X0: torch.Tensor,
                 shift_source: Callable[[int, int], torch.Tensor] | None,
                 mesh=None):
        self._eg, self._e_only, self._solve = eg, e_only, solve
        self._X0 = X0
        self.shift_source = shift_source
        self._mesh = mesh
        self._key = self._shifts = None
        self._solver_diag: dict = {}

    def shifts(self, key):
        """This key's negative shifts; None when the negatives are
        exhaustive (`shift_source` is None)."""
        if self.shift_source is None:
            return None
        if key != self._key:
            self._key, self._shifts = key, self.shift_source(*key)
        return self._shifts

    def energy_and_grad(self, X, key):
        return self._eg(X, self.shifts(key))

    def energy(self, X, key):
        return self._e_only(X, self.shifts(key))

    def make_direction_solver(self):
        def solve(prev_P, X, G):
            P, self._solver_diag = self._solve(G, prev_P)
            return P, P                                # CG warm start

        return solve, torch.zeros_like(self._X0)

    def _host_diag(self, extra: dict) -> dict:
        vals = {**self._solver_diag, **extra}
        tensors = {k: v for k, v in vals.items() if torch.is_tensor(v)}
        if tensors:   # one batched transfer
            host = torch.stack([v.detach().reshape(()).double()
                                for v in tensors.values()]).cpu().tolist()
            vals.update(zip(tensors, host))
        return {k: float(v) for k, v in vals.items()}

    def diagnostics(self) -> dict:
        """Host floats of the last direction solve's diagnostics."""
        return self._host_diag({})


class _NormalizedSparseObjective(_SparseObjective):
    """Sparse backend of the normalized models (ssne/tsne): threads the
    streaming partition-function estimate z through `eg(X, shifts, z) ->
    (E, G, z_new)` and hands it to the engine's checkpoint payload
    (`carry_state` / `restore_carry`), so that a resumed fit replays the
    uninterrupted gradients bit for bit.  The energy uses the instantaneous
    estimate, so the line-search path `e_only` keeps its shape."""

    def __init__(self, eg, e_only, solve, X0, shift_source, mesh=None):
        super().__init__(eg, e_only, solve, X0, shift_source, mesh)
        # z <= 0 means uninitialized: the first application uses its own
        # instantaneous estimate (see energy_and_grad_sparse)
        self._z = torch.zeros((), dtype=X0.dtype, device=X0.device)

    def energy_and_grad(self, X, key):
        E, G, self._z = self._eg(X, self.shifts(key), self._z)
        return E, G

    def carry_state(self) -> torch.Tensor:
        """The streaming z, for the engine's checkpoint payload."""
        return self._z

    def restore_carry(self, z: torch.Tensor) -> None:
        self._z = z.to(self._X0.device)

    def diagnostics(self) -> dict:
        return self._host_diag({"z_ema": self._z})


class _TreeObjective(_SparseObjective):
    """Deterministic Barnes-Hut backend (sparse/farfield.py): the sparse
    objective's closure shape, but nothing is sampled, so the engine's
    deterministic path applies (no draw key; the accepted energy is reused
    rather than evaluated again).  `diagnostics()` adds the grid's health
    (cells visited, realized opening ratio, residual spill, the pair
    partition invariant) computed from the last evaluated X, batched with
    the solver's counters in one host transfer; it is paid only when a
    callback listens."""

    stochastic = False

    def __init__(self, eg, e_only, solve, X0: torch.Tensor, plan):
        super().__init__(eg, e_only, solve, X0, shift_source=None)
        self._plan = plan
        self._last_X = X0

    def energy_and_grad(self, X, key):
        self._last_X = X
        return self._eg(X)

    def energy(self, X, key):
        return self._e_only(X)

    def diagnostics(self) -> dict:
        return self._host_diag(tree_diagnostics(self._last_X, self._plan))


class _DenseMeshObjective(_RankHooks):
    """Dense 2-D-sharded backend: the distributed energy and gradient and a
    direction solve from `solver_factory()`.  Deterministic (the key is
    ignored).  `eg(X) -> (E, G)` hands the engine the whole G on every rank
    (its norm, the line search's dot product and the checkpoint read it),
    and `e_only(X) -> E` serves the line search."""

    stochastic = False

    def __init__(self, mesh, eg, e_only, solver_factory, X0: torch.Tensor):
        self._mesh = mesh
        self._eg, self._e_only = eg, e_only
        self._solver_factory = solver_factory
        self._X0 = X0

    def energy_and_grad(self, X, key):
        return self._eg(X)

    def energy(self, X, key):
        return self._e_only(X)

    def make_direction_solver(self):
        return self._solver_factory()


def build_dense_mesh_objective(cfg, mesh, mspec: EmbedMeshSpec | None = None,
                               Y=None, X0=None, strategy: str = "sd", *,
                               device, phase_times: dict | None = None):
    """(objective, X0) for the dense 2-D-sharded backend over `mesh` (a
    `launch.mesh.Mesh`; `mspec` names its row and column axes, by default
    every axis but the last and the last).

    Every rank builds the affinities and the start from the whole Y (the
    spectral start `laplacian_eigenmaps(Wp) * 0.1` unless X0 is given),
    checks that all ranks hold the same, keeps its tile of W+ and drops the
    rest, so each rank holds O(N^2 / P).  The repulsion takes the unit-W-
    path (W- == 1 off the diagonal for every affinity builder).
    Strategies: ``sd`` (the block-Jacobi Cholesky factor of each row
    block, built by the solver factory, so a resumed fit builds it again),
    ``fp`` (B = 4 D+ + mu I with the full degree vector, taken before the
    affinities are sharded) and ``gd``.  `phase_times`, when given,
    receives ``affinities_s`` and ``spectral_init_s`` (when it ran).
    Every rank calls this with the same arguments."""
    if strategy not in ("sd", "fp", "gd"):
        raise ValueError(
            f"strategy {strategy!r} is not available on the dense-mesh "
            f"backend (have 'sd', 'fp', 'gd')")
    if mspec is None:
        mspec = default_mesh_spec(mesh)
    n = Y.shape[0]
    _layout(mesh, mspec, n)          # fail fast, before the affinities
    Yt = torch.as_tensor(Y, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    with span("graph-build", phase=True, n=n, dense=True):
        aff = make_affinities(Yt, cfg.perplexity, model=cfg.kind)
        if aff.Wp.is_cuda:
            torch.cuda.synchronize(aff.Wp.device)
    t1 = time.perf_counter()
    if X0 is None:
        X0 = laplacian_eigenmaps(aff.Wp, cfg.dim) * 0.1
        if X0.is_cuda:
            torch.cuda.synchronize(X0.device)
        if phase_times is not None:
            phase_times["spectral_init_s"] = time.perf_counter() - t1
    if phase_times is not None:
        phase_times["affinities_s"] = t1 - t0
    X0 = torch.as_tensor(X0, dtype=torch.float32, device=device)
    assert_replicated(mesh, X0, aff.Wp)
    lam = torch.tensor(cfg.lam, dtype=torch.float32, device=device)
    if strategy == "fp":
        dp = degree(attractive_weights(aff, cfg.kind))
        inv_diag = 1.0 / (4.0 * dp + _jitter(torch.min(dp), torch.mean(dp)))
    Wp = shard_pairwise(mesh, mspec, aff.Wp)
    del aff                          # the tile is all this rank keeps

    eg_unit = make_distributed_energy_grad(mesh, mspec, cfg.kind,
                                           unit_wm=True)

    def eg(X):
        E, G = eg_unit(X, Wp, lam)
        return E, replicate(mesh, G, mspec)

    def e_only(X):
        return eg_unit(X, Wp, lam, with_grad=False)

    if strategy == "sd":
        bj_setup = make_block_jacobi_setup(mesh, mspec, cfg.mu_scale)
        bj_solve = make_block_jacobi_solve(mesh, mspec)

        def solver_factory():
            R = bj_setup(Wp)                    # block-Jacobi factors

            def solve(state, X, G):
                P = bj_solve(R, shard_rows(mesh, mspec, G))
                return replicate(mesh, P, mspec), state

            return solve, ()
    elif strategy == "fp":
        def solver_factory():
            def solve(state, X, G):
                return -inv_diag[:, None] * G, state

            return solve, ()
    else:
        def solver_factory():
            return (lambda state, X, G: (-G, state)), ()

    return _DenseMeshObjective(mesh, eg, e_only, solver_factory, X0), X0


def _sparse_spectral_init(cfg, saff, n: int) -> torch.Tensor:
    """Spectral start: the dense eigh up to DENSE_INIT_N points, block power
    iteration on the ELL graph above that (sparse/linalg.py)."""
    if n <= DENSE_INIT_N:
        A = to_dense(saff.graph)
        return laplacian_eigenmaps(0.5 * (A + A.T), cfg.dim) * 0.1
    return sparse_laplacian_eigenmaps(saff.graph, saff.rev, d=cfg.dim,
                                      seed=cfg.seed) * 0.1


def _resolve_saff(cfg, Y, saff, n: int, device, timings: dict | None = None):
    """The calibrated ELL affinities: the caller's precomputed `saff` when
    given (the `fit(saff=...)` path), else built from Y."""
    if saff is not None:
        if saff.graph.n != n:
            raise ValueError(
                f"precomputed saff has {saff.graph.n} rows but the fit is "
                f"over n={n} points")
        return saff
    k = cfg.n_neighbors or min(int(3 * cfg.perplexity), n - 1)
    if k < cfg.perplexity:
        raise ValueError(
            f"n_neighbors={k} < perplexity={cfg.perplexity}: the "
            f"k-candidate entropy cannot reach log(perplexity), so the "
            f"calibration would silently degenerate to uniform weights; use "
            f"n_neighbors >= 3 * perplexity (or 0 for auto)")
    Yt = torch.as_tensor(Y, dtype=torch.float32, device=device)
    return sparse_affinities(Yt, k=k, perplexity=cfg.perplexity,
                             model=cfg.kind, method=cfg.knn_method,
                             timings=timings)


def _graph_and_start(cfg, Y, X0, saff, device, phase_times: dict | None):
    """(n, saff, X0, lam) of the sparse and tree backends: the resolved ELL
    affinities, the starting point (the spectral start unless X0 is given,
    timed into ``phase_times["spectral_init_s"]``) and lam, on `device`."""
    n = Y.shape[0] if Y is not None else saff.graph.n
    saff = _resolve_saff(cfg, Y, saff, n, device, timings=phase_times)
    if X0 is None:
        t0 = time.perf_counter()
        with span("spectral-init", phase=True, n=n):
            X0 = _sparse_spectral_init(cfg, saff, n)
            if X0.is_cuda:
                torch.cuda.synchronize(X0.device)
        if phase_times is not None:
            phase_times["spectral_init_s"] = time.perf_counter() - t0
    X0 = torch.as_tensor(X0, dtype=torch.float32, device=device)
    lam = torch.tensor(cfg.lam, dtype=torch.float32, device=device)
    return n, saff, X0, lam


def _make_direction_solve(strategy: str, matvec, inv_diag, cfg,
                          backend: str):
    """`solve(G, P0) -> (P, diag)`: Jacobi-PCG on B = 4 L(W+) + mu I for
    ``sd``, its diagonal for ``fp``, identity for ``gd``."""
    if strategy == "sd":
        def solve(G, P0):
            r = pcg(matvec, -G, P0, inv_diag=inv_diag, tol=cfg.cg_tol,
                    maxiter=cfg.cg_maxiter)
            return r.x, {"pcg_iters": r.n_iters,
                         "pcg_residual": r.rel_residual}
        return solve
    if strategy == "fp":
        return lambda G, P0: (-inv_diag[:, None] * G, {})
    if strategy == "gd":
        return lambda G, P0: (-G, {})
    raise ValueError(
        f"strategy {strategy!r} is not available on the {backend} backend "
        f"(have 'sd', 'fp', 'gd')")


def build_sparse_objective(cfg, Y=None, X0=None, strategy: str = "sd",
                           sharded: bool = False, saff=None, *, device,
                           mesh=None, mspec: EmbedMeshSpec | None = None,
                           shift_source=None, phase_times: dict | None = None,
                           ell_layout: str | None = None):
    """(objective, X0, saff) for the sparse neighbour-graph backend.

    A precomputed `saff` (sparse.SparseAffinities) skips the k-NN build.
    `shift_source(seed, it)` replaces the default draw of the negatives
    (`draw_shifts`).  `phase_times`, when given, receives the set-up
    seconds: the graph build's steps (``knn_s``, ``calibrate_s``,
    ``reverse_s``) and ``spectral_init_s``.  The CG operator runs the ELL
    kernel with the spec's kernel arguments (impl, bf16 storage) and the
    layout `ell_layout` (None: `kernels.ops.ELL_DEFAULT_LAYOUT`, ``vmem``;
    ``hbm`` is the staged gather, the same bits, which no user option
    selects); the gradient's ELL products take only the spec's impl and
    the default layout, and stay in float32 storage, as the reference's
    do.

    `sharded=True` row-shards the graph over `mesh` (a `launch.mesh.Mesh`;
    `mspec` names its row axes, by default every axis but the last) and
    runs the gradient's and the CG operator's Laplacian products on the
    local-rows kernel with the spec's impl and storage, as the reference's
    sharded backend does; its layout is ``vmem`` only.  Every rank of the
    mesh calls this with the same arguments."""
    if sharded:
        if mesh is None:
            raise ValueError("the sparse-sharded backend needs a mesh")
        if mspec is None:
            mspec = default_mesh_spec(mesh)
        # fail fast on unusable mesh shapes, before the k-NN build
        validate_sparse_mesh(mesh, mspec.row_axes)
        if ell_layout not in (None, "vmem"):
            raise ValueError(f"the sparse-sharded backend runs the vmem "
                             f"layout only, got ell_layout={ell_layout!r}")
    n, saff, X0, lam = _graph_and_start(cfg, Y, X0, saff, device,
                                        phase_times)
    kind, m = cfg.kind, cfg.n_negatives
    normalized = is_normalized(kind)
    sampled = m is not None and m < n - 1
    if sampled and shift_source is None:
        def shift_source(seed, it):
            return draw_shifts(seed, it, n, m, device)
    if not sampled:
        shift_source = None
    obj_cls = (_NormalizedSparseObjective if normalized
               else _SparseObjective)

    if sharded:
        rev = saff.rev
        assert_replicated(mesh, X0, saff.graph.indices, saff.graph.weights,
                          *((rev.indices, rev.weights) if rev is not None
                            else ()))
        sg = shard_sparse_affinities(mesh, mspec.row_axes, saff)
        knobs = {"kernel_impl": cfg.kernel_impl,
                 "kernel_precision": cfg.kernel_precision}
        eg_l, e_l = make_sharded_energy_grad(
            mesh, mspec.row_axes, sg, kind, n_negatives=m,
            z_decay=cfg.z_ema_decay, **knobs)
        if normalized:
            def eg(X, shifts, z):
                return eg_l(X, lam, shifts, z)
        else:
            def eg(X, shifts):
                return eg_l(X, lam, shifts)

        def e_only(X, shifts):
            return e_l(X, lam, shifts)

        matvec, inv_diag, _ = make_sharded_sd_operator(
            mesh, mspec.row_axes, sg, saff, cfg.mu_scale, **knobs)
        solve = _make_direction_solve(strategy, matvec, inv_diag, cfg,
                                      "sparse-sharded")
        return (obj_cls(eg, e_only, solve, X0, shift_source, mesh=mesh), X0,
                saff)

    # the spectral system is model-independent (the paper freezes the
    # attractive Hessian at X = 0), so normalized kinds share the operator
    matvec, inv_diag, _ = make_sd_operator(saff.graph, saff.rev,
                                           cfg.mu_scale, layout=ell_layout,
                                           **cfg.kernel_args())
    impl = cfg.kernel_impl

    if normalized:
        def eg(X, shifts, z):
            return energy_and_grad_sparse(
                X, saff, kind, lam, n_negatives=m, shifts=shifts, z_prev=z,
                z_decay=cfg.z_ema_decay, return_state=True, impl=impl)
    else:
        def eg(X, shifts):
            return energy_and_grad_sparse(X, saff, kind, lam, n_negatives=m,
                                          shifts=shifts, impl=impl)

    def e_only(X, shifts):
        return energy_and_grad_sparse(X, saff, kind, lam, n_negatives=m,
                                      shifts=shifts, with_grad=False,
                                      impl=impl)[0]

    solve = _make_direction_solve(strategy, matvec, inv_diag, cfg, "sparse")
    return obj_cls(eg, e_only, solve, X0, shift_source), X0, saff


def build_tree_objective(cfg, Y=None, X0=None, strategy: str = "sd",
                         saff=None, *, device,
                         phase_times: dict | None = None):
    """(objective, X0, saff) for the deterministic Barnes-Hut backend: exact
    ELL attractive terms plus grid far-field repulsion under the
    `cfg.theta` opening criterion, O(N log N) an iteration, with no random
    draw or EMA anywhere, so repeated fits are bit-identical.  2-D
    embeddings only (the grid is a quadtree).  The direction solves are the
    sparse backend's sd/fp/gd family (the spectral system only sees the
    attractive graph).

    A precomputed `saff` skips the k-NN build; `phase_times` receives the
    set-up seconds as `build_sparse_objective` fills them.  The spec's
    kernel arguments (impl, bf16 storage) reach the cell-interaction kernel
    and the CG operator; the gradient's ELL products take only the impl."""
    if cfg.dim != 2:
        raise ValueError(
            f"the tree backend is 2-D only (quadtree far field); "
            f"got dim={cfg.dim} - use the sparse backend for other dims")
    n, saff, X0, lam = _graph_and_start(cfg, Y, X0, saff, device,
                                        phase_times)
    plan = make_grid_plan(n, theta=cfg.theta, depth=cfg.tree_depth,
                          cap=cfg.tree_cap)
    kernel_args = cfg.kernel_args()

    def eg(X):
        return energy_and_grad_tree(X, saff, lam, cfg.kind, plan,
                                    **kernel_args)

    def e_only(X):
        return energy_and_grad_tree(X, saff, lam, cfg.kind, plan,
                                    with_grad=False, **kernel_args)[0]

    matvec, inv_diag, _ = make_sd_operator(saff.graph, saff.rev,
                                           cfg.mu_scale, **kernel_args)
    solve = _make_direction_solve(strategy, matvec, inv_diag, cfg, "tree")
    return _TreeObjective(eg, e_only, solve, X0, plan), X0, saff
