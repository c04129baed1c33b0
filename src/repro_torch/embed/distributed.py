"""The dense mesh backend's 2-D decomposition of the O(N^2 d) pairwise work
and its block-Jacobi spectral-direction solves.

Port of `repro/embed/distributed.py` on `torch.distributed`, one rank per
device, on a `launch.mesh.Mesh` whose row axes (e.g. ("data",)) split the
rows of the N x N affinities and whose column axis ("model") splits their
columns:

  * X (N, d) is replicated: every rank holds all of it, since its tile needs
    a row block and a column block of X.
  * Wp (and Wm) are 2-D sharded: each rank keeps its (N/R, N/C) tile, the
    only O(N^2) state, and no rank holds the whole matrix once the tile is
    cut (`shard_pairwise`).
  * each rank computes its (row block x column block) tile of the pairwise
    terms of `kernels/ref.py` in plain torch, float32, as the reference's
    tile body is plain `jnp` (its docstring speaks of the Pallas kernel on
    TPU, but the code never calls it; `kernels/csrc/pairwise.cu` takes only
    the square N x N problem with both weight matrices);
  * the row block's Laplacian products are summed over the ranks of its row
    (the column axis), the scalars e_plus and s over every axis; each sum is
    one `all_reduce`, which hands every rank the same bits.

Spectral direction (``block_jacobi``): each row block factors only its own
diagonal block of B = 4 (D+ - W+) + mu I, so the solves need no
communication; B stays positive definite and block-diagonal, so the
direction is still a descent direction.  The diagonal block of the 2-D
sharded W+ is gathered at set-up by a sum over the column axis of each
rank's share of it.

Where JAX runs one program on global arrays, every rank here runs its own
host loop (the fit engine, the line search) on replicated values, as the
row-sharded sparse backend does (sparse/sharding.py): `replicate`
all-gathers a row-sharded result in row order, so every rank reads the same
bits and takes the same decisions.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core.objectives import is_normalized
from repro_torch.kernels.ref import KINDS
from repro_torch.launch.mesh import AxisGroup, Mesh, linear_row_index


@dataclasses.dataclass(frozen=True)
class EmbedMeshSpec:
    """Axis naming for the embedding decomposition."""

    row_axes: tuple[str, ...] = ("data",)
    col_axis: str = "model"

    @property
    def all_axes(self) -> tuple[str, ...]:
        return self.row_axes + (self.col_axis,)


def default_mesh_spec(mesh: Mesh) -> EmbedMeshSpec:
    """Row axes = every mesh axis but the last, which is the column axis
    (a one-axis mesh shards its only axis)."""
    names = mesh.axis_names
    return EmbedMeshSpec(row_axes=tuple(names[:-1]) or (names[0],),
                         col_axis=names[-1])


def _row_groups(mesh: Mesh, spec: EmbedMeshSpec) -> int:
    return math.prod(mesh.shape[ax] for ax in spec.row_axes)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where this rank's tile lies: R x C tiles of (nb_r, nb_c) over an
    N x N matrix, this rank's at row block r and column block c."""

    R: int
    C: int
    r: int
    c: int
    nb_r: int
    nb_c: int


def _layout(mesh: Mesh, spec: EmbedMeshSpec, n: int) -> _Layout:
    """This rank's tile of an N x N matrix; raises for axes the mesh lacks
    and for an N that a tile count does not divide."""
    for ax in spec.all_axes:
        if ax not in mesh.shape:
            raise ValueError(f"mesh axis {ax!r} of {spec} not in mesh axes "
                             f"{mesh.axis_names}")
    if spec.col_axis in spec.row_axes:
        raise ValueError(f"the column axis {spec.col_axis!r} is also a row "
                         f"axis in {spec}")
    R, C = _row_groups(mesh, spec), mesh.shape[spec.col_axis]
    if n % R or n % C:
        raise ValueError(
            f"the dense-mesh backend cuts the N x N affinities into {R} x {C}"
            f" tiles with no padding, so N = {n} must be divisible by both "
            f"(use the dense backend, or a mesh whose axes divide N)")
    return _Layout(R, C, linear_row_index(mesh, spec.row_axes),
                   mesh.coords[spec.col_axis], n // R, n // C)


def _all_reduce(t: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """`t` summed over the ranks of `ag` (in place; nothing for one rank)."""
    if ag.size > 1:
        dist.all_reduce(t, group=ag.group)
    return t


def _tile_terms_local(kind: str, xi, xj, wa, wb, diag_tile: bool,
                      with_grad: bool = True):
    """One tile of the unified pairwise contract (kernels/ref.py):
    (L(a) X rows, L(b) X rows, e_plus, s) of rows xi against columns xj.

    wb=None means W- == 1 off the diagonal (EE with unit repulsion and every
    normalized model): the repulsive weights are then a function of the
    distances alone and take no O(N^2) storage.  The diagonal's spurious
    K(0) in the scalar s is taken out through `diag_tile` (b's Laplacian
    product is immune: w_nn (x_n - x_n) = 0).  `with_grad=False` leaves
    out the two products (None in their place)."""
    f32 = torch.float32
    wa = wa.to(f32)
    xi, xj = xi.to(f32), xj.to(f32)
    ri = torch.sum(xi * xi, dim=-1, keepdim=True)
    rj = torch.sum(xj * xj, dim=-1, keepdim=True)
    t = torch.clamp_min(ri + rj.T - 2.0 * (xi @ xj.T), 0.0)
    if wb is None:
        diag_n = xi.shape[0] * float(diag_tile)    # K(0) = 1 each
    else:
        wb = wb.to(f32)
        diag_n = 0.0
    if kind in ("ee", "ssne"):
        a = wa
        b = torch.exp(-t) if wb is None else wb * torch.exp(-t)
        ep, s = torch.sum(wa * t), torch.sum(b) - diag_n
    elif kind == "tsne":
        K = 1.0 / (1.0 + t)
        a = wa * K
        b = K * K if wb is None else wb * K * K
        kk = K if wb is None else wb * K
        ep, s = torch.sum(wa * torch.log1p(t)), torch.sum(kk) - diag_n
    elif kind == "tee":
        K = 1.0 / (1.0 + t)
        a = wa
        b = K * K if wb is None else wb * K * K
        kk = K if wb is None else wb * K
        ep, s = torch.sum(wa * t), torch.sum(kk) - diag_n
    elif kind == "epan":
        supp = (t < 1.0).to(t.dtype)
        a = wa
        b = supp if wb is None else wb * supp
        kk = torch.clamp_min(1.0 - t, 0.0)
        kk = kk if wb is None else wb * kk
        ep, s = torch.sum(wa * t), torch.sum(kk) - diag_n
    else:
        raise ValueError(kind)
    if not with_grad:
        return None, None, ep, s
    la = torch.sum(a, dim=1, keepdim=True) * xi - a @ xj
    lb = torch.sum(b, dim=1, keepdim=True) * xi - b @ xj
    return la, lb, ep, s


def make_distributed_energy_grad(mesh: Mesh, spec: EmbedMeshSpec, kind: str,
                                 unit_wm: bool = False):
    """(X, Wp, Wm, lam) -> (E, G) with G this rank's row block (N/R, d), or
    (X, Wp, lam) -> (E, G) when `unit_wm` (W- == 1 off the diagonal: the
    repulsive weights are recomputed from the distances).  `with_grad=False`
    returns E alone, the same bits, without the Laplacian products.

    X (N, d) is the replicated embedding; Wp and Wm are this rank's (N/R,
    N/C) tiles (`shard_pairwise`).  E is the same on every rank.  Every rank
    of the mesh calls it with the same X and lam."""
    if kind not in KINDS:
        raise ValueError(kind)
    normalized = is_normalized(kind)
    row = mesh.axis_group((spec.col_axis,))     # the ranks of this row
    every = mesh.axis_group(spec.all_axes)

    def core(X, Wp, Wm, lam, with_grad):
        lay = _layout(mesh, spec, X.shape[0])
        if tuple(Wp.shape) != (lay.nb_r, lay.nb_c):
            raise ValueError(f"this rank's tile is ({lay.nb_r}, {lay.nb_c})"
                             f" of N = {X.shape[0]}, got {tuple(Wp.shape)}")
        xi = X[lay.r * lay.nb_r:(lay.r + 1) * lay.nb_r]
        xj = X[lay.c * lay.nb_c:(lay.c + 1) * lay.nb_c]
        # the tile holds diagonal entries of its row block's own column
        # block; each row block counts its nb_r diagonal entries once
        diag_tile = lay.c == (lay.r * lay.C) // lay.R
        la, lb, ep, s = _tile_terms_local(kind, xi, xj, Wp, Wm, diag_tile,
                                          with_grad)
        ep, s = _all_reduce(torch.stack([ep, s]), every)
        E = ep + lam * torch.log(s) if normalized else ep + lam * s
        if not with_grad:
            return E
        d = la.shape[1]
        la, lb = _all_reduce(torch.cat([la, lb], dim=1), row).split(d, dim=1)
        if normalized:
            G = 4.0 * (la - (lam / s) * lb)
        else:
            G = 4.0 * (la - lam * lb)
        return E, G

    if unit_wm:
        def eg(X, Wp, lam, with_grad: bool = True):
            return core(X, Wp, None, lam, with_grad)
    else:
        def eg(X, Wp, Wm, lam, with_grad: bool = True):
            return core(X, Wp, Wm, lam, with_grad)
    return eg


def make_block_jacobi_setup(mesh: Mesh, spec: EmbedMeshSpec,
                            mu_scale: float = 1e-5):
    """(Wp,) -> R, the lower Cholesky factor (N/R, N/R) of this rank's row
    block's diagonal block of B = 4 (D+ - W+) + mu I, computed without
    forming B whole.  Wp is this rank's tile; the ranks of a row get the
    same factor.

    The degrees are the tile's row sums summed over the column axis.  The
    diagonal block W+[rows, rows] is, on each rank, the part of it that
    falls in the rank's columns, placed at its offset and zero elsewhere,
    and the block is the sum of those parts over the column axis (each of
    its columns lies in exactly one rank's columns).  The reference cuts a
    fixed-width window and masks it, for shard_map's static shapes; where R
    and C divide one another (every mesh `make_host_mesh` builds) the two
    are the same block."""
    row = mesh.axis_group((spec.col_axis,))

    def setup(Wp):
        nb_r, n_loc_c = Wp.shape
        lay = _layout(mesh, spec, nb_r * _row_groups(mesh, spec))
        if n_loc_c != lay.nb_c:
            raise ValueError(f"this rank's tile is ({lay.nb_r}, {lay.nb_c}),"
                             f" got {tuple(Wp.shape)}")
        deg = _all_reduce(torch.sum(Wp, dim=1), row)           # (nb_r,)
        row0, col0 = lay.r * nb_r, lay.c * n_loc_c
        lo, hi = max(row0, col0), min(row0 + nb_r, col0 + n_loc_c)
        block = Wp.new_zeros((nb_r, nb_r))
        if hi > lo:
            block[:, lo - row0:hi - row0] = Wp[:, lo - col0:hi - col0]
        block = _all_reduce(block, row)
        B = 4.0 * (torch.diag(deg) - block)
        bd = torch.diagonal(B)
        mu = torch.maximum(1e-10 * torch.min(bd), mu_scale * torch.mean(bd))
        B = B + mu * torch.eye(nb_r, dtype=B.dtype, device=B.device)
        return torch.linalg.cholesky(B)

    return setup


def make_block_jacobi_solve(mesh: Mesh, spec: EmbedMeshSpec):
    """(R, G) -> P = -B^{-1} G on this rank's row block: one triangular
    solve pair with the set-up's factor and no communication."""

    def solve(R, G):
        return -torch.cholesky_solve(G, R)

    return solve


def shard_pairwise(mesh: Mesh, spec: EmbedMeshSpec,
                   W: torch.Tensor) -> torch.Tensor:
    """This rank's (N/R, N/C) tile of an (N, N) weight matrix, on W's device,
    contiguous and with storage of its own, so that the whole W can be
    dropped."""
    lay = _layout(mesh, spec, W.shape[0])
    tile = W[lay.r * lay.nb_r:(lay.r + 1) * lay.nb_r,
             lay.c * lay.nb_c:(lay.c + 1) * lay.nb_c]
    return tile.contiguous() if tile.numel() == W.numel() else tile.clone(
        memory_format=torch.contiguous_format)


def shard_rows(mesh: Mesh, spec: EmbedMeshSpec,
               X: torch.Tensor) -> torch.Tensor:
    """This rank's row block (N/R, d) of a replicated (N, d), contiguous."""
    lay = _layout(mesh, spec, X.shape[0])
    return X[lay.r * lay.nb_r:(lay.r + 1) * lay.nb_r].contiguous()


def replicate(mesh: Mesh, X: torch.Tensor,
              spec: EmbedMeshSpec | None = None) -> torch.Tensor:
    """The whole (N, d) on every rank from each rank's row block `X` (N/R,
    d) of a layout row-sharded over `spec.row_axes` (by default every mesh
    axis but the last): one all_gather over the ranks that share this
    rank's column, laid out in row-block order, as
    sparse/sharding.py::_replicate_rows does.  It only copies rows, so every
    rank holds the same bits."""
    spec = spec if spec is not None else default_mesh_spec(mesh)
    col = mesh.axis_group(spec.row_axes)
    if col.size == 1:
        return X
    out = X.new_empty((col.size * X.shape[0], X.shape[1]))
    dist.all_gather_into_tensor(out, X.contiguous(), group=col.group)
    # the group lays its members out in rank order; their row blocks
    # follow the row axes' order, which is the same unless the row axes
    # are named out of the mesh's order
    blocks = []
    for rank in col.ranks:
        coords, idx = mesh.coords_of(rank), 0
        for ax in spec.row_axes:
            idx = idx * mesh.shape[ax] + coords[ax]
        blocks.append(idx)
    order = sorted(range(col.size), key=blocks.__getitem__)
    if order != list(range(col.size)):
        out = out.view(col.size, X.shape[0], -1)[order].reshape(out.shape)
    return out
