"""Baseline optimizers the paper compares against: L-BFGS and nonlinear CG.

Port of `repro/core/baselines.py`.  Both are expressed in the same Strategy
interface as the partial-Hessian methods (strategies.py), so the minimizer,
line search and accounting are identical across all methods, as in the
paper's experimental setup.

L-BFGS: two-loop recursion over a circular buffer of m (s, y) pairs (the
paper found m = 100 best).  Pairs are only stored when <s, y> > 1e-10 (the
curvature condition), the standard safeguard with a backtracking
(Armijo-only) line search.  The reference runs both loops over all m slots
with masking; masked slots leave q and r bit-unchanged.  Here the loops run
over the slots that can hold a pair (at most one per earlier call, a count
kept on the host), masked on the device by the valid count: the same bits,
and no value is read back.

Nonlinear CG: Polak-Ribiere+ with automatic restarts when the direction
loses descent.

Whether a call is the first is known on the host (`started`), so the first
direction is -G itself.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

State = Any


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The flat dot product of two (N, d) arrays (`jnp.vdot`)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


@dataclasses.dataclass(frozen=True)
class LBFGS:
    name: str = "L-BFGS"
    m: int = 100

    def init(self, X0, aff, kind, lam) -> State:
        z = torch.zeros((self.m,) + tuple(X0.shape), dtype=X0.dtype,
                        device=X0.device)
        zero = torch.zeros((), dtype=torch.int64, device=X0.device)
        return {
            "S": z,
            "Y": z,
            "rho": torch.zeros((self.m,), dtype=X0.dtype, device=X0.device),
            "head": zero,          # next write slot
            "count": zero,         # valid pairs
            "pushes": 0,           # pairs offered so far (host): >= count
            "prev_X": X0,
            "prev_G": torch.zeros_like(X0),
            "started": False,
        }

    def _push(self, state, X, G):
        if not state["started"]:
            return state
        s = X - state["prev_X"]
        y = G - state["prev_G"]
        sty = _vdot(s, y)
        ok = sty > 1e-10
        head = state["head"]
        slot = head.reshape(1)

        def put(buf, value):
            # buf[head] = value where ok, out of place
            return buf.index_copy(0, slot, torch.where(
                ok, value[None], buf.index_select(0, slot)))

        return {
            **state,
            "S": put(state["S"], s),
            "Y": put(state["Y"], y),
            "rho": put(state["rho"], 1.0 / sty),
            "head": torch.where(ok, (head + 1) % self.m, head),
            "count": torch.where(ok, torch.clamp_max(state["count"] + 1,
                                                     self.m),
                                 state["count"]),
            "pushes": state["pushes"] + 1,
        }

    def direction(self, state, X, G, aff, kind, lam):
        state = self._push(state, X, G)
        m, count, head = self.m, state["count"], state["head"]
        n_slots = min(state["pushes"], m)
        q = G
        r = q
        if n_slots:
            # slot i = 0 is the newest pair; slots i >= count are masked
            i = torch.arange(n_slots, device=X.device)
            order = (head - 1 - i) % m
            S = state["S"].index_select(0, order)
            Y = state["Y"].index_select(0, order)
            rho = state["rho"].index_select(0, order)
            valid = i < count
            alphas = []
            for k in range(n_slots):
                a = rho[k] * _vdot(S[k], q)
                q = torch.where(valid[k], q - a * Y[k], q)
                alphas.append(a)
            yty = _vdot(Y[0], Y[0])
            gamma = torch.where(
                count > 0, _vdot(S[0], Y[0]) / torch.clamp_min(yty, 1e-30),
                1.0)
            r = gamma * q
            for k in reversed(range(n_slots)):      # oldest -> newest
                b = rho[k] * _vdot(Y[k], r)
                r = torch.where(valid[k], r + (alphas[k] - b) * S[k], r)
        P = -r
        # descent safeguard
        P = torch.where(_vdot(P, G) < 0, P, -G)
        state = {**state, "prev_X": X, "prev_G": G, "started": True}
        return P, state


@dataclasses.dataclass(frozen=True)
class NonlinearCG:
    name: str = "CG"

    def init(self, X0, aff, kind, lam) -> State:
        return {
            "prev_G": torch.zeros_like(X0),
            "prev_P": torch.zeros_like(X0),
            "started": False,
        }

    def direction(self, state, X, G, aff, kind, lam):
        if state["started"]:
            pg = state["prev_G"]
            beta = _vdot(G, G - pg) / torch.clamp_min(_vdot(pg, pg), 1e-30)
            beta = torch.clamp_min(beta, 0.0)   # PR+
            P = -G + beta * state["prev_P"]
        else:
            P = -G
        # restart if not a descent direction
        P = torch.where(_vdot(P, G) < 0, P, -G)
        return P, {"prev_G": G, "prev_P": P, "started": True}
