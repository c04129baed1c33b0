"""The implicit symmetric W+ = (A + A^T) / 2 of a directed graph A stored
as (indices, weights) (N, k), built once as a float64 CSR matrix: its
degrees, W+ X, and the Laplacian product L(W+) X = D+ X - W+ X."""
from __future__ import annotations

import warnings

import torch


class SymGraph:
    def __init__(self, idx: torch.Tensor, w: torch.Tensor):
        n, k = idx.shape
        rows = torch.arange(n, device=idx.device).repeat_interleave(k)
        cols = idx.reshape(-1)
        vals = 0.5 * w.reshape(-1).double()
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        with warnings.catch_warnings():      # sparse tensors are "beta"
            warnings.simplefilter("ignore", UserWarning)
            W = torch.sparse_coo_tensor(
                torch.stack([torch.cat([rows, cols]), torch.cat([cols, rows])]),
                torch.cat([vals, vals]), (n, n), check_invariants=False)
            self.W = W.coalesce().to_sparse_csr()
        self.deg = self.matvec(torch.ones((n, 1), dtype=torch.float64,
                                          device=idx.device))[:, 0]

    def matvec(self, X: torch.Tensor) -> torch.Tensor:
        return self.W @ X

    def lap(self, X: torch.Tensor) -> torch.Tensor:
        return self.deg[:, None] * X - self.W @ X
