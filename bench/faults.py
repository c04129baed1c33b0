"""Faults planted in the program under test, to show that the check of
`correct` fails them and to read the numbers they give (`calibrate.py`,
`tests/test_bench_faults.py`).  Each is a context manager that patches the
imported `repro_torch` for its block and restores it after:

  * `stuck`: a step that returns its state unchanged (the dense fused
    step hands back X as it came; the sparse direction is zero);
  * `half_batch`: half of the points left out, the mean taken over the
    rest (the dense objective on the first half of the points, doubled;
    the sparse gradient's rows of the second half dropped, the first half
    doubled);
  * `altered`: an answer altered where it is produced (every 1000th row
    of a fit's embedding moved by the embedding's spread);
  * `wrong_start`: the spectral start built from the next eigenvectors
    (the second and third nontrivial ones);
  * `stale`: from a fit's 4th iteration on, the direction is not solved
    again and the last one is reused (past the steps a check of the first
    three sees).

The one-chip cells have no exchange between chips to leave out."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def stuck():
    from repro_torch.core import minimize
    from repro_torch.embed import trainer

    def step(old):
        def f(strategy, kind, ls_cfg, X, E, G, state, *args):
            out = old(strategy, kind, ls_cfg, X, E, G, state, *args)
            return (X, E, G) + tuple(out[3:])
        return f

    def solve(old):
        def f(strategy, matvec, inv_diag, cfg, backend):
            inner = old(strategy, matvec, inv_diag, cfg, backend)

            def s(G, P0):
                P, diag = inner(G, P0)
                return P * 0.0, diag
            return s
        return f

    with _patched(minimize, "_step", step), \
            _patched(trainer, "_make_direction_solve", solve):
        yield


@contextlib.contextmanager
def half_batch():
    from repro_torch.core import minimize
    from repro_torch.core.affinities import Affinities
    from repro_torch.embed import trainer

    def dense(old):
        def f(X, aff, kind, lam, **impl):
            h = X.shape[0] // 2
            sub = Affinities(aff.Wp[:h, :h].contiguous(),
                             aff.Wm[:h, :h].contiguous())
            E, Gh = old(X[:h].contiguous(), sub, kind, lam, **impl)
            G = X.new_zeros(X.shape)
            G[:h] = 2.0 * Gh
            return 2.0 * E, G
        return f

    def sparse(old):
        def f(X, *args, **kw):
            out = old(X, *args, **kw)
            if out[1] is None:
                return out
            h = X.shape[0] // 2
            G = out[1].clone()
            G[:h] *= 2.0
            G[h:] = 0.0
            return (out[0], G) + tuple(out[2:])
        return f

    with _patched(minimize, "energy_and_grad", dense), \
            _patched(minimize, "energy",
                     lambda old: lambda X, aff, kind, lam, **impl:
                     minimize.energy_and_grad(X, aff, kind, lam, **impl)[0]), \
            _patched(trainer, "energy_and_grad_sparse", sparse):
        yield


@contextlib.contextmanager
def altered():
    from repro_torch.api import backends

    def fit(old):
        def f(*args, **kw):
            res, aff, X0 = old(*args, **kw)
            X = res.X.clone()
            X[::1000] += X.std(0)
            res.X = X
            return res, aff, X0
        return f

    with _patched(backends, "fit_dense", fit), \
            _patched(backends, "fit_sparse", fit):
        from repro_torch.api import registries
        saved = {k: registries.BACKENDS[k].fit for k in ("dense", "sparse")}
        registries.BACKENDS["dense"].fit = backends.fit_dense
        registries.BACKENDS["sparse"].fit = backends.fit_sparse
        try:
            yield
        finally:
            for k, v in saved.items():
                registries.BACKENDS[k].fit = v


@contextlib.contextmanager
def wrong_start():
    from repro_torch.api import backends
    from repro_torch.embed import trainer

    def nxt(old):
        def f(g, rev=None, d=2, **kw):
            return old(g, rev, d=d + 1, **kw)[:, 1:]
        return f

    def nxt_dense(old):
        def f(Wp, d=2):
            return old(Wp, d + 1)[:, 1:]
        return f

    with _patched(backends, "laplacian_eigenmaps", nxt_dense), \
            _patched(trainer, "laplacian_eigenmaps", nxt_dense), \
            _patched(trainer, "sparse_laplacian_eigenmaps", nxt):
        yield


@contextlib.contextmanager
def stale(after: int = 3):
    from repro_torch.core import minimize
    from repro_torch.embed import trainer

    def fused(old):
        def f(self):
            real, calls, last = self.strategy, [0], [None]

            class Stale:
                def __getattr__(self, name):
                    return getattr(real, name)

                def direction(self, state, *args):
                    calls[0] += 1
                    if calls[0] > after:
                        return last[0], state
                    P, state = real.direction(state, *args)
                    last[0] = P
                    return P, state
            proxy = Stale()

            def step(X, E, G, state, alpha_prev):
                return minimize._step(proxy, self.kind, self.ls_cfg, X, E, G,
                                      state, alpha_prev, self.aff,
                                      self._kernel_aff, self.lam, self.impl)
            return step
        return f

    def solve(old):
        def f(strategy, matvec, inv_diag, cfg, backend):
            inner, calls, last = (old(strategy, matvec, inv_diag, cfg,
                                      backend), [0], [None])

            def s(G, P0):
                calls[0] += 1
                if calls[0] > after:
                    return last[0], {"pcg_iters": 0, "pcg_residual": 0.0}
                out = inner(G, P0)
                last[0] = out[0]
                return out
            return s
        return f

    with _patched(minimize.DenseObjective, "make_fused_step", fused), \
            _patched(trainer, "_make_direction_solve", solve):
        yield


FAULTS = {"stuck": stuck, "half_batch": half_batch, "altered": altered,
          "wrong_start": wrong_start, "stale": stale}
