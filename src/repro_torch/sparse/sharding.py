"""Row-sharded sparse backend: the ELL neighbour graph over a process group.

Port of `repro/sparse/sharding.py` on `torch.distributed`, one rank per
device.  The multi-device analogue of the single-device sparse pipeline
(sparse/linalg.py + core/objectives.energy_and_grad_sparse):

  * the directed ELL graph AND its precomputed reverse (transpose) graph are
    row-sharded: each rank keeps only its own rows of both, padded with
    zero rows to a common shard size.  The reverse graph keeps the implicit
    symmetrization W = (A + A^T)/2 gather-only on every rank, so there is no
    all-to-all and no scatter in the hot path;
  * X (N, d) is replicated: each rank gathers arbitrary neighbour rows of X
    locally, and one `all_gather_into_tensor` of the ranks' equal,
    contiguous row blocks into the (N_pad, d) slab re-replicates an update.
    It only copies rows, so every rank holds the same bits (the reference's
    `psum` of disjoint zero-padded slabs is exact too, and gives the same);
  * the attractive energy and the partial partition-function estimate share
    one more `all_reduce`, of a 2-vector.

Both Laplacian halves run through the local-rows ELL product
(`kernels.ops.ell_lap_matvec_local`, the CUDA kernel on the GPU), in the
gradient and in every matvec of the CG solve.  Negative sampling keeps the
cyclic-shift structure of `energy_and_grad_sparse`: the transpose of the
sampled edge set is the negated shifts, so the reverse half of the repulsive
Laplacian is again a local gather, with its weights recomputed from the
symmetric distance rather than fetched from another rank.

Where JAX runs one program over all devices, here every rank runs its own
host loop (the engine, the line search, the PCG loop of sparse/linalg.py)
on replicated values.  The ranks stay in lockstep because every host
decision reads the same bits on every rank: the same graph and start (built
by every rank from the same data and seeds, and checked by
`assert_replicated`), the same negative shifts (drawn from a CPU generator
with the same seed), and collectives that hand every rank the same result.
The one per-rank input, the wall clock of a time budget, is agreed with
`max_over_ranks`.

The mesh may have axes beyond the row axes only at size 1:
`validate_sparse_mesh` rejects other shapes with the reference's message.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import objectives
from repro_torch.kernels import ops
from repro_torch.kernels.ref import negative_pair_terms
from repro_torch.launch.mesh import Mesh, linear_row_index
from repro_torch.obs import span

from .graph import SparseAffinities, reverse_graph
from .linalg import make_sd_operator


class ShardedSparseGraph(NamedTuple):
    """This rank's rows of the row-padded ELL graph and reverse graph."""

    indices: torch.Tensor       # (nb, k) int32, global column ids
    weights: torch.Tensor       # (nb, k)
    rev_indices: torch.Tensor   # (nb, k_rev) int32
    rev_weights: torch.Tensor   # (nb, k_rev)
    n: int                      # true row count (n_pad - n padded zero rows)
    n_pad: int                  # nb * the number of row groups
    row0: int                   # this rank's first global row


def validate_sparse_mesh(mesh: Mesh, row_axes: tuple[str, ...]) -> None:
    """Raise for mesh shapes the row-sharded sparse path can't use."""
    for ax in row_axes:
        if ax not in mesh.shape:
            raise ValueError(
                f"row axis {ax!r} not in mesh axes {tuple(mesh.shape)}")
    bad = {ax: s for ax, s in mesh.shape.items()
           if ax not in row_axes and s != 1}
    if bad:
        raise ValueError(
            f"sparse=True shards the ELL graph over rows only "
            f"({row_axes!r}); every other mesh axis must have size 1, got "
            f"{bad}.  Reshape the mesh so all devices sit on the row axes "
            f"(e.g. (n_devices, 1) for a ('data', 'model') mesh).")
    # the slab is all-gathered in rank order, so shard i must be rank i's:
    # the row axes of size > 1 must come in the mesh's own order
    wide = [ax for ax in row_axes if mesh.shape[ax] > 1]
    if wide != [ax for ax in mesh.shape if mesh.shape[ax] > 1]:
        raise ValueError(
            f"row axes {row_axes!r} must name the mesh's axes of size > 1 "
            f"in the mesh's order {tuple(mesh.shape)}: shard i is rank i's")


def _row_groups(mesh: Mesh, row_axes: tuple[str, ...]) -> int:
    g = 1
    for ax in row_axes:
        g *= mesh.shape[ax]
    return g


def shard_sparse_affinities(mesh: Mesh, row_axes: tuple[str, ...],
                            saff: SparseAffinities) -> ShardedSparseGraph:
    """Pad the ELL arrays to a row-group multiple and keep this rank's rows.

    Shards have nb = ceil(n / groups) rows rounded up to a multiple of 8,
    the reference's sizing, so that every rank's row0 is the reference's.
    Padded rows get index 0 / weight 0: a zero-weight edge contributes
    exactly zero to every operator, and index 0 keeps gathers in bounds.
    The graph's indices are checked to lie in [0, n) here, once a fit: the
    local-rows kernel gathers them unchecked in every call."""
    validate_sparse_mesh(mesh, row_axes)
    g = saff.graph
    rev = saff.rev if saff.rev is not None else reverse_graph(g)
    n = g.n
    for name, idx in (("indices", g.indices), ("reverse indices",
                                                rev.indices)):
        lo, hi = torch.stack([idx.min(), idx.max()]).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"the graph's {name} must lie in [0, {n}), "
                             f"got [{lo}, {hi}]")
    groups = _row_groups(mesh, row_axes)
    nb = -(-n // groups)
    nb = -(-nb // 8) * 8
    row0 = linear_row_index(mesh, row_axes) * nb

    def local(a: torch.Tensor) -> torch.Tensor:
        real = a[min(row0, n):min(row0 + nb, n)]
        return torch.cat([real, a.new_zeros((nb - real.shape[0],
                                             a.shape[1]))])

    with span("graph-shard", phase=True, n=n, n_pad=nb * groups,
              groups=groups):
        return ShardedSparseGraph(
            indices=local(g.indices.to(torch.int32)),
            weights=local(g.weights),
            rev_indices=local(rev.indices.to(torch.int32)),
            rev_weights=local(rev.weights), n=n, n_pad=nb * groups,
            row0=row0)


def _pad_rows(X: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = X.shape[0]
    return X if n_pad == n else torch.cat([X, X.new_zeros((n_pad - n,
                                                           X.shape[1]))])


def _replicate_rows(mesh: Mesh, local: torch.Tensor,
                    n_pad: int) -> torch.Tensor:
    """The (n_pad, d) slab of every rank's `local` rows in rank order: the
    shards are equal, contiguous row blocks, so one all_gather_into_tensor
    (a collective both NCCL and gloo take on CUDA tensors) lays them out
    with no zero fill and no sum."""
    out = local.new_empty((n_pad, local.shape[1]))
    dist.all_gather_into_tensor(out, local.contiguous(), group=mesh.group)
    return out


def max_over_ranks(mesh: Mesh, value: float, device) -> float:
    """The largest of the ranks' `value`s, on every rank (one all_reduce
    MAX): how ranks agree on a reading of their own clocks."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t.cpu())


def assert_replicated(mesh: Mesh, *tensors: torch.Tensor) -> None:
    """Raise on every rank unless every rank holds the same `tensors`, as
    far as two float64 checksums each can tell.  A mesh fit needs
    every rank to build the same graph and start: a rank that disagreed
    would take other host decisions and leave the others waiting in a
    collective.  One all_reduce MAX of the checksums and their negations
    gives every rank the largest and the smallest of each, so all reach the
    same verdict (all_reduce is the collective both NCCL and gloo take on
    CUDA tensors).  One rank agrees with itself: nothing to check."""
    if mesh.size == 1:
        return
    sums = []
    for t in tensors:
        flat = t.detach().reshape(-1).double()
        ramp = torch.arange(flat.numel(), dtype=torch.float64,
                            device=flat.device) % 1021 + 1
        sums += [flat.sum(), (flat * ramp).sum()]
    mine = torch.stack(sums)
    both = torch.cat([mine, -mine])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    if not torch.equal(both[:mine.numel()], -both[mine.numel():]):
        raise RuntimeError(
            "the ranks hold different graphs or starting points; the mesh "
            "backends need every rank to build them from the same data "
            "with the same seeds on deterministic devices")


def _local_lap_fn(nb: int, k: int, kernel_impl: str, kernel_precision: str):
    """The per-rank directed Laplacian: rows [row0, row0 + nb) of L(A) V
    for a replicated V, through `ops.ell_lap_matvec_local` (the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors, both at the storage
    precision `kernel_precision`).  The request is checked here, before the
    fit starts."""
    kw = ops.resolve_local_ell(nb, k, 0, impl=kernel_impl,
                               storage_dtype=kernel_precision)

    def lap(Vp, idx, w, row0):
        return ops.ell_lap_matvec_local(Vp, idx, w, row0, **kw)

    return lap


def make_sharded_energy_grad(mesh: Mesh, row_axes: tuple[str, ...],
                             sg: ShardedSparseGraph, kind: str,
                             n_negatives: int | None = 5,
                             z_decay: float = 0.9,
                             kernel_impl: str = "auto",
                             kernel_precision: str = "float32"):
    """Sharded energy/gradient closures for every model family.

    Unnormalized kinds (ee/tee/epan): `eg(X, lam, shifts) -> (E, G)` and
    `e_only(X, lam, shifts) -> E` (the line-search fast path).

    Normalized kinds (ssne/tsne): `eg(X, lam, shifts, z_prev) -> (E, G, z)`
    threads the streaming partition-function estimate: each rank's partial
    Z rides the same all_reduce as its attractive energy, and the EMA update
    runs replicated on the total, so every rank carries the same z.
    `e_only(X, lam, shifts) -> E` uses the instantaneous log(s_hat).

    `shifts` are the sampled negatives' cyclic shifts ((n_negatives,) ints
    in 1..n-1, `core.objectives.draw_shifts`), None when the negatives are
    exhaustive.  X (n, d) is the replicated embedding; G comes back
    replicated.  Both closures match the single-device
    `energy_and_grad_sparse` on the same graph, shifts and z_prev (the same
    per-pair math; only partial-sum order differs), and every rank must
    call them with the same arguments.

    `kernel_impl`/`kernel_precision` select the local Laplacian products'
    path and storage (`kernels.ops`); bfloat16 storage rounds X and the
    attractive weights of both halves, on the kernel and on its plain
    version alike, as the reference does with its local kernel active."""
    negative_pair_terms(kind, torch.zeros(()))  # reject bad kinds at build
    normalized = objectives.is_normalized(kind)
    n, n_pad, row0 = sg.n, sg.n_pad, sg.row0
    nb = sg.indices.shape[0]
    exhaustive = n_negatives is None or n_negatives >= n - 1
    lap = _local_lap_fn(nb, sg.indices.shape[1], kernel_impl,
                        kernel_precision)
    idx, w, ridx, rw = sg.indices, sg.weights, sg.rev_indices, sg.rev_weights

    def body(X, lam, shifts, z_prev, with_grad):
        dev, dt = X.device, X.dtype
        if exhaustive:
            shifts = torch.arange(1, n, dtype=torch.int32, device=dev)
            scale = 1.0
        else:
            if shifts is None or shifts.shape != (n_negatives,):
                raise ValueError(
                    f"sampled negatives need their ({n_negatives},) shifts "
                    f"(draw_shifts), got "
                    f"{None if shifts is None else tuple(shifts.shape)}")
            shifts = shifts.to(device=dev, dtype=torch.int32)
            scale = (n - 1) / n_negatives
        Xp = _pad_rows(X, n_pad)
        xi = Xp[row0:row0 + nb]
        rows_g = torch.arange(row0, row0 + nb, dtype=torch.int32,
                              device=dev)[:, None]
        live = (rows_g < n).to(dt)                             # (nb, 1)

        # attractive: exact over the local ELL rows (t is symmetric, so the
        # directed sum needs no transpose pass for the energy); padded rows
        # have zero weights, so e_pair and aw vanish there
        t_att = torch.sum((xi[:, None, :] - Xp[idx]) ** 2, dim=-1)
        e_pair, aw = objectives.attractive_edge_terms(kind, w, t_att)
        e_plus = torch.sum(e_pair)

        # repulsive: cyclic-shift negatives at the global row ids
        J = (rows_g + shifts[None, :]) % n                     # (nb, m)
        t_neg = torch.sum((xi[:, None, :] - Xp[J]) ** 2, dim=-1)
        s_pair, b = negative_pair_terms(kind, t_neg)
        s_hat = scale * torch.sum(live * s_pair)

        # the partials of every rank, summed ONCE: e_plus and s_hat (the
        # partial Z for normalized kinds) share the collective
        tot = torch.stack([e_plus, s_hat])
        dist.all_reduce(tot, group=mesh.group)
        e_plus_g, s_hat_g = tot[0], tot[1]
        if normalized:
            E = e_plus_g + lam * torch.log(s_hat_g)
            if exhaustive or z_prev is None:
                z = s_hat_g             # exact Z: nothing left to smooth
            else:
                zd = torch.full((), z_decay, dtype=dt, device=dev)
                z = torch.where(z_prev > 0,
                                zd * z_prev + (1.0 - zd) * s_hat_g, s_hat_g)
        else:
            E = e_plus_g + lam * s_hat_g
            z = None
        if not with_grad:
            return E

        # both symmetrization halves as local gathers: A via the local graph
        # rows, A^T via the local reverse-graph rows.  t-SNE's edge weight
        # K = 1/(1+t) is a function of the symmetric distance, so each half
        # recomputes it from its own local distances
        if kind == "tsne":
            arw = objectives.attractive_edge_terms(
                kind, rw,
                torch.sum((xi[:, None, :] - Xp[ridx]) ** 2, dim=-1))[1]
            la_x = 0.5 * (lap(Xp, idx, aw, row0) + lap(Xp, ridx, arw, row0))
        else:
            la_x = 0.5 * (lap(Xp, idx, w, row0) + lap(Xp, ridx, rw, row0))

        # reverse negative half: the transpose of shift +s_j is shift -s_j
        # at the same per-edge weight, a function of the symmetric distance:
        # recomputed locally instead of fetched from the source row's rank
        b = live * b
        Jr = (rows_g - shifts[None, :]) % n
        t_rev = torch.sum((xi[:, None, :] - Xp[Jr]) ** 2, dim=-1)
        b_rev = live * negative_pair_terms(kind, t_rev)[1]
        lb_x = 0.5 * scale * (objectives.directed_lap_apply(b, xi, Xp[J])
                              + objectives.directed_lap_apply(b_rev, xi,
                                                              Xp[Jr]))

        lam_rep = (lam / z) if normalized else lam
        G_loc = 4.0 * (la_x - lam_rep * lb_x)
        G = _replicate_rows(mesh, G_loc, n_pad)[:n]     # O(N d) comm
        return (E, G, z) if normalized else (E, G)

    if normalized:
        def eg(X, lam, shifts, z_prev):
            return body(X, lam, shifts, z_prev, True)
    else:
        def eg(X, lam, shifts):
            return body(X, lam, shifts, None, True)

    def e_only(X, lam, shifts):
        return body(X, lam, shifts, None, False)

    return eg, e_only


def make_sharded_sd_operator(mesh: Mesh, row_axes: tuple[str, ...],
                             sg: ShardedSparseGraph, saff: SparseAffinities,
                             mu_scale: float = 1e-5,
                             kernel_impl: str = "auto",
                             kernel_precision: str = "float32"):
    """(matvec, inv_diag, mu) for B = 4 L((A + A^T)/2) + mu I with the
    Laplacian application row-sharded.

    The Jacobi diagonal and mu come from `sparse.linalg.make_sd_operator`
    on the unsharded graph, which every rank holds from the build, so the
    sharded CG solves the bit-identical system; only the single-device
    matvec is discarded.  The matvec is 2 (L(A) V + L(A^T) V) over the local
    rows, through the local-rows kernel (`kernel_impl`/`kernel_precision`
    as in `make_sharded_energy_grad`), one all-gather to re-replicate, then
    + mu V.  This is the CG hot path."""
    _, inv_diag, mu = make_sd_operator(saff.graph, saff.rev, mu_scale)
    n, n_pad, row0 = sg.n, sg.n_pad, sg.row0
    lap = _local_lap_fn(sg.indices.shape[0], sg.indices.shape[1],
                        kernel_impl, kernel_precision)

    def matvec(V):
        Vp = _pad_rows(V, n_pad)
        out_loc = 2.0 * (lap(Vp, sg.indices, sg.weights, row0)
                         + lap(Vp, sg.rev_indices, sg.rev_weights, row0))
        return _replicate_rows(mesh, out_loc, n_pad)[:n] + mu * V

    return matvec, inv_diag, mu
