"""The sparse backend's sampled objective in float64.

Attractive side, exact over the graph's edges (the implicit W+ =
(A + A^T) / 2): E+ sums the edges' terms (w t, or w log(1 + t) for t-SNE)
and L(a) X is half the directed product over A plus half over A^T, each
edge weighted a = w (a = w / (1 + t) for t-SNE, from its own distance).

Repulsive side, by cyclic-shift negatives: iteration `it`'s m shifts are
1 + the first m of a permutation of 0 .. N-2 drawn on the CPU from the
generator seeded (seed << 32) + it; row n's negatives are n + s_j mod N,
each pair's terms scaled by (N - 1) / m, and the transpose of that edge
set is the shifts negated.  The normalized kinds take log(s) in the
energy and, in the gradient, 1 / z for a streaming z = decay z_prev +
(1 - decay) s (z = s at first)."""
from __future__ import annotations

import torch

BLOCK = 131072
NORMALIZED = ("ssne", "tsne")


def shifts(seed: int, it: int, n: int, m: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed((seed << 32) + it)
    return (1 + torch.randperm(n - 1, generator=g)[:m]).to(device)


def _neg_terms(kind, t):
    if kind in ("ee", "ssne"):
        e = torch.exp(-t)
        return e, e
    if kind in ("tee", "tsne"):
        K = 1.0 / (1.0 + t)
        return K, K * K
    if kind == "epan":
        return torch.clamp_min(1.0 - t, 0.0), (t < 1.0).double()
    raise ValueError(kind)


def _dla(w, x, xj):
    return torch.sum(w, 1, keepdim=True) * x - torch.einsum("nk,nkd->nd",
                                                             w, xj)


class Objective:
    def __init__(self, idx, w, kind: str, lam: float, m: int, seed: int,
                 z_decay: float):
        self.idx, self.w, self.kind, self.lam = idx, w, kind, lam
        self.m, self.seed, self.z_decay = m, seed, z_decay
        self.z = None

    def _attractive(self, X, with_grad):
        e_plus = torch.zeros((), dtype=torch.float64, device=X.device)
        la = torch.zeros_like(X) if with_grad else None
        n, B = X.shape[0], BLOCK
        for r0 in range(0, n, B):
            ib, wb = self.idx[r0:r0 + B], self.w[r0:r0 + B]
            diff = X[r0:r0 + B, None, :] - X[ib]
            t = torch.sum(diff * diff, -1)
            if self.kind == "tsne":
                e_plus += torch.sum(wb * torch.log1p(t))
                a = wb / (1.0 + t)
            else:
                e_plus += torch.sum(wb * t)
                a = wb
            if with_grad:
                contrib = a[:, :, None] * diff          # a (x_n - x_j)
                la[r0:r0 + B] += 0.5 * torch.sum(contrib, 1)
                la.index_add_(0, ib.reshape(-1),
                              -0.5 * contrib.reshape(-1, X.shape[1]))
        return e_plus, la

    def __call__(self, X, it: int, with_grad: bool = True):
        """(E, G) of iteration `it`'s draw; G is None without `with_grad`,
        and only a gradient evaluation advances z."""
        X = X.double()
        n, m = X.shape[0], self.m
        e_plus, la = self._attractive(X, with_grad)
        s = shifts(self.seed, it, n, m, X.device)
        rows = torch.arange(n, device=X.device)[:, None]
        J = (rows + s[None, :]) % n
        sp, b = _neg_terms(self.kind, torch.sum((X[:, None, :] - X[J]) ** 2,
                                                -1))
        scale = (n - 1) / m
        s_hat = scale * torch.sum(sp)
        normalized = self.kind in NORMALIZED
        E = float(e_plus + self.lam * (torch.log(s_hat) if normalized
                                       else s_hat))
        if not with_grad:
            return E, None
        Jr = (rows - s[None, :]) % n
        b_rev = b[Jr, torch.arange(m, device=X.device)[None, :]]
        lb = 0.5 * scale * (_dla(b, X, X[J]) + _dla(b_rev, X, X[Jr]))
        if normalized:
            self.z = (s_hat if self.z is None
                      else self.z_decay * self.z + (1 - self.z_decay) * s_hat)
            c = self.lam / self.z
        else:
            c = self.lam
        return E, 4.0 * (la - c * lb)
