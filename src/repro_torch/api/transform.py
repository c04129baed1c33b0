"""Out-of-sample `transform()`: embed unseen points against a FROZEN training
embedding, never re-fitting.

Port of `repro/api/transform.py`.  The training pairs (Y_train, X_train)
define the map, and a new point y is embedded by minimizing the same
attraction-repulsion energy restricted to its own coordinates, with every
training coordinate held constant:

  * attraction: kNN affinities of y against the TRAINING set, calibrated
    per row to the spec's perplexity as in training
    (`sparse.graph.calibrated_weights_ell` over the `knn_cross` candidates;
    above `CROSS_APPROX_N` training rows the random-projection candidate
    search replaces the exact blocked scan);
  * repulsion: y against `n_negatives` uniformly drawn training anchors,
    scaled by N/m (`exhaustive=True`: every anchor, deterministic).
    Normalized kinds (ssne, tsne) use each new point's own partition
    function over the anchors, log-weighted as in training.

The anchors never move, so the problem separates across new points, the
attractive Hessian is diagonal, and an iteration costs O(n_new (k + m) d).

Two solvers (`TransformSpec.solver`):

  * ``'engine'`` (default): the energy summed over the batch through the
    shared `fit_loop`, one global backtracking line search;
  * ``'rowwise'``: per-row Armijo backtracking on the row's own anchored
    energy, a per-row adaptive-grow step and per-row convergence freezing.
    Nothing couples rows (the sampled anchors of iteration `it` are one
    draw for all rows), so a row's result does not depend on the rest of
    its batch: the property `repro_torch.serve`'s micro-batching and
    padding rest on.

Batch invariance.  The reference gets it from XLA, which compiles every
n >= 2 batch to the same per-row arithmetic (and duplicates a lone row).
PyTorch picks a reduction's split and a matrix product's kernel from the
whole tensor's shape, so here each row's arithmetic is kept independent of
the row count by construction:

  * the cross-kNN and the calibration run on blocks of exactly `ROW_BLOCK`
    rows (the last one padded), so every kernel sees the same shapes;
  * the solver's sums over a row's slots, anchors and dimensions are
    `_fixed_sum`s: pairwise sums of slices, an order set by the summed
    length alone, every step an element-wise add;
  * everything else is element-wise or a gather.

The rowwise solver reads the device about once an iteration: it runs the
backtracking in `TRIES_PER_READ` masked tries between reads (a row that has
accepted keeps its step, flag and energy, so the extra tries change
nothing) and tests "every row frozen" on the next iteration's read, where a
speculative iteration over frozen rows moves nothing.

Random draws.  The sampled anchors come from `anchor_source(seed, it) ->
(m,)` distinct ints in [0, n_train): the engine solver draws iteration `it`
with the engine's key (seed + 1, it), the rowwise solver with (seed, it),
the counterparts of the reference's `fold_in(PRNGKey(seed + 1), it)` and
`fold_in(PRNGKey(seed), it)`.  `jax.random` cannot be replayed in torch:
the default source (`draw_anchors`) is a CPU `torch.Generator`, and the
tests pass JAX's draws in.  The approximate cross-kNN takes its directions
as `projections=` likewise.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.guards import explicit_read
from repro_torch.core.objectives import (attractive_edge_terms, is_normalized,
                                         negative_pair_terms)
from repro_torch.embed.engine import LoopConfig, fit_loop
from repro_torch.obs import span
from repro_torch.sparse.graph import (CROSS_APPROX_N, calibrated_weights_ell,
                                      knn_cross)

from .spec import TransformSpec

#: rows of every cross-kNN and calibration block of a transform
ROW_BLOCK = 64
#: backtracking tries of the rowwise solver between two device reads
TRIES_PER_READ = 2


def _fixed_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over `dim` in an order set by x.shape[dim] alone: halves added
    element-wise until one slice is left (an odd length keeps its last
    slice for the next round).  Equal slices give equal bits whatever the
    other dimensions hold or measure."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        s = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([s, x[..., 2 * h:]], dim=-1) if n % 2 else s
    return x[..., 0]


def draw_anchors(seed: int, it: int, n_train: int, m: int) -> torch.Tensor:
    """m distinct anchors in [0, n_train) for iteration `it`: the default
    `anchor_source`, from a CPU generator seeded by (seed, it).  It gives
    other numbers than the reference's draw from the same seed."""
    g = torch.Generator().manual_seed((seed << 32) + it)
    return torch.randperm(n_train, generator=g)[:m]


def _anchor_rows(anchors: torch.Tensor, J) -> torch.Tensor:
    return anchors[torch.as_tensor(J, device=anchors.device).long()]


class _RowEnergy:
    """Each row's anchored energy (and gradient) over its kNN anchors and
    one set of repulsive anchors A_J, every sum a `_fixed_sum`."""

    def __init__(self, kind: str, lam, anchors: torch.Tensor,
                 nn_idx: torch.Tensor, nn_w: torch.Tensor, scale: float):
        self.kind = kind
        self.lam = float(lam)
        self.normalized = is_normalized(kind)
        self.A_nn = anchors[nn_idx.long()]             # (n, k, d)
        self.nn_w = nn_w
        self.scale = scale

    def __call__(self, X: torch.Tensor, A_J: torch.Tensor,
                 with_grad: bool = False):
        diff_a = X[:, None, :] - self.A_nn               # (n, k, d)
        e_pair, a = attractive_edge_terms(
            self.kind, self.nn_w, _fixed_sum(diff_a * diff_a, -1))
        e_rows = _fixed_sum(e_pair, -1)
        diff_j = X[:, None, :] - A_J[None]               # (n, M, d)
        s_pair, b = negative_pair_terms(self.kind,
                                        _fixed_sum(diff_j * diff_j, -1))
        s_row = self.scale * _fixed_sum(s_pair, -1)
        if self.normalized:
            e = e_rows + self.lam * torch.log(torch.clamp_min(s_row, 1e-30))
        else:
            e = e_rows + self.lam * s_row
        if not with_grad:
            return e
        # dt/dx = 2 (x - anchor); de+/dt = a; ds/dt = -b; the repulsion's
        # weight is lam, or lam / s for the log of a normalized kind
        rep = (torch.where(s_row > 1e-30, self.lam / s_row, 0.0)[:, None]
               if self.normalized else self.lam)
        ga = _fixed_sum(a[..., None] * diff_a, 1)        # (n, d)
        gb = _fixed_sum(b[..., None] * diff_j, 1)
        G = 2.0 * ga - (2.0 * self.scale) * rep * gb
        return e, G


class TransformObjective:
    """Fixed-anchor objective over the new rows only (engine protocol).

    `stochastic` follows the negative draw: sampled anchors make the engine
    pass one key (seed, it) an iteration, which `anchor_source` turns into
    the iteration's anchors (common random numbers in the line search, EMA
    convergence); the exhaustive mode is deterministic."""

    def __init__(self, kind: str, lam, anchors: torch.Tensor,
                 nn_idx: torch.Tensor, nn_w: torch.Tensor,
                 n_negatives: int | None, anchor_source=None):
        n_train = anchors.shape[0]
        exhaustive = n_negatives is None or n_negatives >= n_train
        self.stochastic = not exhaustive
        self._anchors = anchors
        self._source = anchor_source or (
            lambda seed, it: draw_anchors(seed, it, n_train, n_negatives))
        self._rows = _RowEnergy(kind, lam, anchors, nn_idx, nn_w,
                                1.0 if exhaustive else n_train / n_negatives)
        # anchored attractive Hessian is diagonal: B = 4 diag(row deg) + mu
        # (frozen at X = 0 as in the SD family; calibrated rows sum to ~1)
        deg = torch.sum(nn_w, dim=1)
        mu = torch.maximum(1e-10 * torch.min(4.0 * deg),
                           1e-5 * torch.mean(4.0 * deg))
        self._inv_diag = 1.0 / (4.0 * deg + mu)

    def _draw(self, key) -> torch.Tensor:
        if key is None:
            return self._anchors
        return _anchor_rows(self._anchors, self._source(*key))

    def energy_and_grad(self, X, key):
        e, G = self._rows(X, self._draw(key), with_grad=True)
        return torch.sum(e), G

    def energy(self, X, key):
        return torch.sum(self._rows(X, self._draw(key)))

    def make_direction_solver(self):
        def solve(state, X, G):
            return -self._inv_diag[:, None] * G, state

        return solve, ()


# -- the rowwise (batch-invariant) solver --------------------------------------


@dataclasses.dataclass
class RowwiseResult:
    """Host-side summary of one rowwise solve (the lightweight analogue of
    the engine path's `EngineResult`)."""

    X: torch.Tensor
    n_iters: int              # outer iterations actually run
    n_rows: int
    n_converged: int          # rows frozen by the per-row tests
    n_evals: int = 0          # energy evaluations, gradients included
    n_reads: int = 0          # device-to-host reads


def _host_flags(*flags: torch.Tensor) -> list[bool]:
    """all() of each bool tensor, in one device-to-host read."""
    with explicit_read():
        return [bool(v)
                for v in torch.stack([f.all() for f in flags]).tolist()]


def rowwise_transform(kind: str, lam, anchors: torch.Tensor,
                      nn_idx: torch.Tensor, nn_w: torch.Tensor,
                      X0: torch.Tensor, *, n_negatives: int | None,
                      max_iters: int, tol: float, seed: int, ls,
                      anchor_source=None) -> RowwiseResult:
    """Solve the anchored problem row-independently (module docstring).
    `n_negatives=None` (or >= n_train) is the exhaustive deterministic
    mode; otherwise iteration `it` repels from `anchor_source(seed, it)`."""
    n_train = anchors.shape[0]
    exhaustive = n_negatives is None or n_negatives >= n_train
    n_rows = X0.shape[0]
    source = anchor_source or (
        lambda s, i: draw_anchors(s, i, n_train, n_negatives))
    energy = _RowEnergy(kind, lam, anchors, nn_idx, nn_w,
                        1.0 if exhaustive else n_train / n_negatives)
    rho, c1 = ls.rho, ls.c1
    # per-row diagonal preconditioner B_r = 4 deg_r + mu_r with a PER-ROW
    # damping (a global mu would couple rows through the batch)
    deg = _fixed_sum(nn_w, -1)
    inv_diag = 1.0 / (4.0 * deg + torch.clamp_min(4e-5 * deg, 1e-12))
    # trust cap scale: spread of the (fixed) anchor embedding
    a_c = anchors - torch.mean(anchors, dim=0, keepdim=True)
    a_rms = torch.sqrt(torch.mean(a_c * a_c)) + 1e-3

    X = X0
    alpha_prev = torch.ones((n_rows,), dtype=X0.dtype, device=X0.device)
    frozen = torch.zeros((n_rows,), dtype=torch.bool, device=X0.device)
    A_J = anchors
    it = n_evals = n_reads = 0
    while it < max_iters:
        if not exhaustive:
            A_J = _anchor_rows(anchors, source(seed, it))
        e_rows, G = energy(X, A_J, with_grad=True)
        n_evals += 1
        P = -inv_diag[:, None] * G
        dgp = _fixed_sum(G * P, -1)
        # adaptive-grow initial step and per-row trust cap
        alpha = torch.clamp_max(alpha_prev / rho, 1.0)
        if ls.max_rel_move is not None:
            p_rms = torch.sqrt(_fixed_sum(P * P, -1) / P.shape[1]) + 1e-30
            alpha = torch.minimum(alpha, ls.max_rel_move * a_rms / p_rms)
        a = torch.where(frozen, 0.0, alpha)
        ok, e_new = frozen, e_rows
        tries = 0
        while True:
            for _ in range(min(TRIES_PER_READ, ls.max_backtracks - tries)):
                e_t = energy(X + a[:, None] * P, A_J)
                n_evals += 1
                ok_now = e_t <= e_rows + c1 * a * dgp
                e_new = torch.where(~ok & ok_now, e_t, e_new)
                a = torch.where(ok | ok_now, a, a * rho)
                ok = ok | ok_now
                tries += 1
            all_ok, all_frozen = _host_flags(ok, frozen)
            n_reads += 1
            if all_frozen or all_ok or tries >= ls.max_backtracks:
                break
        if all_frozen:
            break         # every row froze last iteration: nothing moved
        failed = ~ok & ~frozen                  # line search exhausted
        alpha_f = torch.where(ok & ~frozen, a, 0.0)
        X = X + alpha_f[:, None] * P
        # per-row raw convergence on the common-random-numbers pair
        rel = torch.abs(e_rows - e_new) / torch.clamp_min(
            torch.abs(e_rows), 1e-30)
        frozen = frozen | failed | (~frozen & (rel < tol))
        alpha_prev = torch.where(alpha_f > 0, alpha_f, alpha_prev)
        it += 1
    with explicit_read():       # the reference's one read of (it, n_conv)
        n_conv = int(torch.sum(frozen))
    return RowwiseResult(X=X, n_iters=it, n_rows=n_rows, n_converged=n_conv,
                         n_evals=n_evals, n_reads=n_reads + 1)


# -- cross affinities ----------------------------------------------------------


def _anchor_affinities(Y_new: torch.Tensor, Y_train: torch.Tensor, k: int,
                       perplexity: float, method: str = "exact",
                       n_projections: int = 8, window: int = 16,
                       knn_seed: int = 0, projections=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(idx, w), both (n_new, k): each new row's k training neighbours and
    their calibrated weights, computed on blocks of `ROW_BLOCK` rows.
    Approximate candidates may carry +inf duplicate markers; their
    calibrated weight is exactly 0, so they act as padded slots."""
    n = Y_new.shape[0]
    n_pad = -(-n // ROW_BLOCK) * ROW_BLOCK
    Yp = torch.cat([Y_new, Y_new[:1].expand(n_pad - n, -1)])
    kw = ({"n_projections": n_projections, "window": window,
           "seed": knn_seed, "projections": projections}
          if method == "approx" else {})
    d2, idx = knn_cross(Yp, Y_train, k, block_rows=ROW_BLOCK, method=method,
                        **kw)
    valid = torch.ones((ROW_BLOCK, k), dtype=torch.bool, device=d2.device)
    w = torch.cat([calibrated_weights_ell(d2[r0:r0 + ROW_BLOCK], valid,
                                          perplexity)
                   for r0 in range(0, n_pad, ROW_BLOCK)])
    return idx[:n], w[:n]


def resolve_transform_spec(spec, tspec: TransformSpec | None
                           ) -> TransformSpec:
    """Fill a `TransformSpec`'s deferred (zero/None) fields from the fitted
    `EmbedSpec`; returns the concrete spec serving will use."""
    if tspec is None:
        tspec = TransformSpec()
    changes = {}
    if tspec.max_iters == 0:
        changes["max_iters"] = int(spec.transform_iters)
    if tspec.n_negatives == 0:
        changes["n_negatives"] = int(spec.transform_negatives)
    if tspec.tol is None:
        changes["tol"] = float(spec.tol)
    return tspec.replace(**changes) if changes else tspec


def _resolve_k(spec, tspec: TransformSpec, n_train: int,
               perplexity: float) -> int:
    k = tspec.k_cross or spec.n_neighbors or int(3 * perplexity)
    k = min(k, n_train)
    if k < perplexity:
        raise ValueError(
            f"transform k={k} < perplexity={perplexity}: the candidate "
            f"entropy cannot reach log(perplexity) (use more training points "
            f"or a smaller perplexity)")
    return k


def _cross_method(tspec: TransformSpec, n_train: int) -> str:
    if tspec.knn_method == "auto":
        return "exact" if n_train <= CROSS_APPROX_N else "approx"
    return tspec.knn_method


def transform_points(spec, Y_train, X_train, Y_new, *,
                     tspec: TransformSpec | None = None, anchor_source=None,
                     projections=None):
    """Embed `Y_new` against the frozen (Y_train, X_train) map.

    Runs on X_train's device; `Y_train` and `Y_new` (arrays or tensors) go
    there as float32.  `anchor_source` replaces the sampled anchors' draw
    and `projections` the approximate cross-kNN's directions (module
    docstring).  Returns `(X_new, result)`: an `EngineResult` (engine
    solver), a `RowwiseResult` (rowwise solver), or None for an empty
    batch.  X_train is only ever READ.
    """
    tspec = resolve_transform_spec(spec, tspec)
    anchors = torch.as_tensor(X_train)
    dev = anchors.device
    Y_train = torch.as_tensor(Y_train, dtype=torch.float32, device=dev)
    Y_new = torch.as_tensor(Y_new, dtype=torch.float32, device=dev)
    if Y_new.shape[0] == 0:
        return anchors.new_zeros((0, anchors.shape[1])), None
    n_train = Y_train.shape[0]
    k = _resolve_k(spec, tspec, n_train, spec.perplexity)
    method = _cross_method(tspec, n_train)
    # on CUDA the span times the issue of the kNN and calibration
    with span("cross-knn", phase=True, n_new=int(Y_new.shape[0]), k=k,
              method=method):
        idx, w = _anchor_affinities(
            Y_new, Y_train, k, float(spec.perplexity), method=method,
            n_projections=tspec.n_projections, window=tspec.window,
            knn_seed=tspec.seed, projections=projections)
    m = None if tspec.exhaustive else tspec.n_negatives

    # init each new point at its calibrated anchor barycenter
    X0 = _fixed_sum(w[..., None] * anchors[idx.long()], 1)

    if tspec.solver == "rowwise":
        n = Y_new.shape[0]
        bs = tspec.batch_size or n
        parts = [rowwise_transform(
            spec.kind, spec.lam, anchors, idx[i:i + bs], w[i:i + bs],
            X0[i:i + bs], n_negatives=m, max_iters=tspec.max_iters,
            tol=tspec.tol, seed=tspec.seed, ls=spec.resolved_ls(),
            anchor_source=anchor_source) for i in range(0, n, bs)]
        if len(parts) == 1:
            res = parts[0]
        else:
            res = RowwiseResult(
                X=torch.cat([r.X for r in parts]),
                n_iters=max(r.n_iters for r in parts), n_rows=n,
                n_converged=sum(r.n_converged for r in parts),
                n_evals=sum(r.n_evals for r in parts),
                n_reads=sum(r.n_reads for r in parts))
        return res.X, res

    obj = TransformObjective(spec.kind, spec.lam, anchors, idx, w, m,
                             anchor_source=anchor_source)
    cfg = LoopConfig(max_iters=tspec.max_iters, tol=tspec.tol,
                     ls=spec.resolved_ls(),
                     seed=tspec.seed if tspec.seed else spec.seed)
    res = fit_loop(obj, X0, cfg)
    return res.X, res

