"""Partial-Hessian search-direction strategies (paper §2).

Port of `repro/core/strategies.py`.  Every strategy defines a pd matrix
B_k and the direction p_k = -B_k^{-1} g_k.  The choices reproduce the
paper's lineup:

  GD       B = I                             (gradient descent)
  FP       B = 4 D+ (x) I_d                  (diagonal fixed-point iteration)
  DiagH    B = max(diag(full Hessian), mu)   (diagonal of the Hessian)
  SD       B = 4 L+_kappa (x) I_d + mu I     (the spectral direction;
                                              Cholesky factor cached at init)
  SD-      B_i = 4 L+ + 8 [L^xx]_{ii}^psd    (adds repulsive curvature;
                                              inexact batched-CG solve)
  SparseSD SD's system over an ELL graph     (matrix-free Jacobi-PCG)

The kappa knob sparsifies L+ through the k-NN graph as in the paper: kappa
>= N-1 is the full spectral direction, kappa = 0 degenerates to FP.
Strategy objects are frozen; per-run tensors (the Cholesky factor, warm
starts) live in the `state` dict returned by `init`.  The inexact solves
(SD-'s batched CG, SparseSD's PCG) read one flag back per CG iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.sparse.graph import NeighborGraph, from_dense, reverse_graph
from repro_torch.sparse.linalg import pcg, sym_degree, sym_lap_matvec

from .affinities import Affinities
from .cg import batched_cg
from .hessians import diag_hessian, xx_weights_ii
from .laplacian import degree, sparsified_attractive_matrix
from .objectives import attractive_weights

State = Any


def _jitter(Bdiag_min: torch.Tensor, Bdiag_mean: torch.Tensor) -> torch.Tensor:
    """Paper's mu = 1e-10 min(L+_nn), floored relative to the mean degree
    for float32 robustness (the paper ran double precision)."""
    return torch.maximum(1e-10 * Bdiag_min, 1e-6 * Bdiag_mean)


@dataclasses.dataclass(frozen=True)
class GD:
    name: str = "GD"

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        return ()

    def direction(self, state, X, G, aff, kind, lam):
        return -G, state


@dataclasses.dataclass(frozen=True)
class FP:
    """Diagonal fixed-point method: B = 4 D+ (Carreira-Perpinan 2010)."""

    name: str = "FP"

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        dp = degree(attractive_weights(aff, kind))
        mu = _jitter(torch.min(dp), torch.mean(dp))
        return {"inv_diag": 1.0 / (4.0 * dp + mu)}

    def direction(self, state, X, G, aff, kind, lam):
        return -state["inv_diag"][:, None] * G, state


@dataclasses.dataclass(frozen=True)
class DiagH:
    """Diagonal of the full Hessian, clipped positive (recomputed each k)."""

    name: str = "DiagH"
    floor_scale: float = 1e-8

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        return ()

    def direction(self, state, X, G, aff, kind, lam):
        d = diag_hessian(X, aff, kind, lam)
        floor = self.floor_scale * torch.clamp_min(torch.max(torch.abs(d)),
                                                   1e-30)
        return -G / torch.maximum(d, floor), state


@dataclasses.dataclass(frozen=True)
class SD:
    """The spectral direction (the paper's headline strategy).

    B = 4 (D+ - W+_kappa) + mu I is constant; its Cholesky factor is
    computed once in `init`, and every iteration costs two triangular
    solves (O(N^2 d)) plus `refine` steps of iterative refinement.

    float32 adaptations (the paper ran double precision): mu = mu_scale *
    mean(diag B) (`mu_scale=None` gives the paper's 1e-10 min(L+_nn)), and
    the line search caps the first trial displacement (LSConfig.
    max_rel_move).
    """

    name: str = "SD"
    kappa: int = -1   # -1 => no sparsification (kappa = N in paper notation)
    mu_scale: float | None = 1e-5
    refine: int = 1

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        Wp = attractive_weights(aff, kind)
        n = Wp.shape[0]
        kappa = self.kappa if self.kappa >= 0 else n
        B = 4.0 * sparsified_attractive_matrix(Wp, kappa)
        bd = torch.diagonal(B)
        if self.mu_scale is None:
            mu = 1e-10 * torch.min(bd)          # paper's setting
        else:
            mu = torch.maximum(1e-10 * torch.min(bd),
                               self.mu_scale * torch.mean(bd))
        B.diagonal().add_(mu)                   # B + mu I, in place
        return {"chol": torch.linalg.cholesky(B), "B": B}   # lower factor

    def direction(self, state, X, G, aff, kind, lam):
        R = state["chol"]
        P = -torch.cholesky_solve(G, R)
        for _ in range(self.refine):
            resid = -G - state["B"] @ P
            P = P + torch.cholesky_solve(resid, R)
        return P, state


@dataclasses.dataclass(frozen=True)
class SDMinus:
    """SD-: adds the psd same-dimension repulsive curvature blocks.

    B_i = 4 L+ + 8 relu(w^xx_ii)-Laplacian, one N x N block per embedding
    dimension; solved inexactly by warm-started batched CG (paper: rel tol
    0.1, <= 50 iterations).  The blocks are built in the buffer of the
    weights: off the diagonal B = Bplus - 8 w, on it Bplus + 8 sum(w) (the
    diagonal weights are 0), the reference's bits without its (d, N, N)
    identity product and Laplacian.
    """

    name: str = "SD-"
    kappa: int = -1
    cg_tol: float = 0.1
    cg_maxiter: int = 50

    def init(self, X0, aff: Affinities, kind: str, lam) -> State:
        Wp = attractive_weights(aff, kind)
        n = Wp.shape[0]
        kappa = self.kappa if self.kappa >= 0 else n
        Bplus = 4.0 * sparsified_attractive_matrix(Wp, kappa)
        bd = torch.diagonal(Bplus)
        mu = _jitter(torch.min(bd), torch.mean(bd))
        Bplus.diagonal().add_(mu)               # Bplus + mu I, in place
        return {"Bplus": Bplus, "prev_P": torch.zeros_like(X0)}

    def direction(self, state, X, G, aff, kind, lam):
        B = xx_weights_ii(X, aff, kind, lam).clamp_min_(0.0)   # (d, N, N)
        rowsum = torch.sum(B, dim=-1)
        B.mul_(-8.0).add_(state["Bplus"])
        B.diagonal(dim1=1, dim2=2).add_(8.0 * rowsum)
        res = batched_cg(B, (-G.T).contiguous(),
                         state["prev_P"].T.contiguous(),
                         tol=self.cg_tol, maxiter=self.cg_maxiter)
        P = res.x.T.contiguous()
        return P, {**state, "prev_P": P}


@dataclasses.dataclass(frozen=True)
class SparseSD:
    """Spectral direction from ELL storage: no (N, N) system, no Cholesky.

    B = 4 (D+ - W+_k) + mu I applied matrix-free over the neighbour graph
    (sparse/linalg.py, the ELL kernel on CUDA), solved by Jacobi-
    preconditioned CG warm-started from the previous direction.  Accepts
    either a `sparse.SparseAffinities` (the graph is the attractive graph,
    D+ its degree) or a dense `Affinities` (converted by per-row top-k; D+
    stays the FULL degree, preserving the paper's kappa semantics where
    k = 0 degenerates to FP and k = N-1 recovers the exact spectral
    direction).

    Each iteration costs O(cg_iters * N * k * d), the same order as the
    sparse gradient, against SD's O(N^2 d) triangular solves.
    """

    name: str = "SparseSD"
    k: int = -1                  # ELL width for dense conversion; -1 => N-1
    mu_scale: float | None = 1e-5
    cg_tol: float = 1e-3
    cg_maxiter: int = 100

    def init(self, X0, aff, kind: str, lam) -> State:
        if hasattr(aff, "graph"):                 # SparseAffinities
            g = aff.graph
            rev = aff.rev if aff.rev is not None else reverse_graph(g)
            dfull = sym_degree(g)
        else:
            Wp = attractive_weights(aff, kind)
            n = Wp.shape[0]
            if self.k == 0:
                # FP limit: an all-padding graph (L = 0), so B = 4 D+ + mu I
                g = NeighborGraph(
                    indices=torch.arange(n, dtype=torch.int32,
                                         device=Wp.device)[:, None],
                    weights=torch.zeros((n, 1), dtype=Wp.dtype,
                                        device=Wp.device))
            else:
                g = from_dense(Wp, self.k if self.k > 0 else n - 1)
            rev = reverse_graph(g)
            dfull = degree(Wp)                    # paper's kappa semantics
        dsym = sym_degree(g)
        bd = 4.0 * dfull
        if self.mu_scale is None:
            mu = 1e-10 * torch.min(bd)            # paper's setting
        else:
            mu = torch.maximum(1e-10 * torch.min(bd),
                               self.mu_scale * torch.mean(bd))
        # B v = 4 L(W+_k) v + resid v + mu v; resid >= 0 keeps B pd when
        # the sparsified graph drops degree mass (cf. laplacian.py)
        resid = 4.0 * torch.clamp_min(dfull - dsym, 0.0)
        return {
            "indices": g.indices, "weights": g.weights,
            "rev_indices": rev.indices, "rev_weights": rev.weights,
            "shift": resid + mu, "inv_diag": 1.0 / (4.0 * dsym + resid + mu),
            "prev_P": torch.zeros_like(X0),
        }

    def direction(self, state, X, G, aff, kind, lam):
        g = NeighborGraph(state["indices"], state["weights"])
        rev = NeighborGraph(state["rev_indices"], state["rev_weights"])
        shift = state["shift"]

        def matvec(V):
            return 4.0 * sym_lap_matvec(g, V, rev=rev) + shift[:, None] * V

        res = pcg(matvec, -G, state["prev_P"], inv_diag=state["inv_diag"],
                  tol=self.cg_tol, maxiter=self.cg_maxiter)
        return res.x, {**state, "prev_P": res.x}


STRATEGIES = {
    "gd": GD,
    "fp": FP,
    "diagh": DiagH,
    "sd": SD,
    "sd-": SDMinus,
    "sparsesd": SparseSD,
}


def make_strategy(name: str, **kwargs):
    try:
        return STRATEGIES[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; have "
                         f"{sorted(STRATEGIES)}")
