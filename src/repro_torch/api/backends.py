"""Backend implementations for the `repro_torch.api` registry.

Port of `repro/api/backends.py`.  Each is `fit(spec, Y, *, X0, aff, saff,
device, mesh, mesh_spec, callback, shift_source, telemetry) ->
(EngineResult, affinities, X0)`; only the mesh backends read `mesh` and
`mesh_spec`:

  * `fit_dense` builds the problem (perplexity affinities, then a
    Laplacian-eigenmaps start, each skipped when the caller passes it), the
    strategy and the dense objective, and runs the fit engine;
  * `fit_dense_mesh` builds the affinities and start on every rank of the
    mesh, keeps each rank's tile of the 2-D-sharded affinities and the
    block-Jacobi, FP or GD direction (embed/trainer.py), and runs the same
    loop on every rank; it returns no affinities (no rank keeps them
    whole);
  * `fit_sparse` builds the ELL neighbour graph (skipped for a precomputed
    `saff=`), the spectral start and the sparse objective
    (embed/trainer.py), and runs the engine's host loop;
  * `fit_sparse_sharded` builds the same graph and start on every rank of
    the mesh and the row-sharded objective (sparse/sharding.py), and runs
    the same loop on every rank;
  * `fit_tree` builds the same graph and start and the deterministic
    Barnes-Hut objective (sparse/farfield.py), and runs the same loop.

Precomputed inputs pin their family: `aff=` (dense `core.Affinities`) is
for the single-device dense backend only (the mesh backend shards its own),
`saff=` (`sparse.SparseAffinities`) is for the sparse and tree backends (the
sharded one cuts its shards from its own build, as the reference's does),
and `shift_source=` (the draw of the negatives) is for
the sparse backends; each backend rejects the other family's with a pointed
error.

Telemetry: each backend activates `telemetry.tracer` around both the
problem's build (so that the ``graph-build`` and ``spectral-init`` spans
land in the trace; the dense backends' close after a synchronisation; the
dense mesh backend, as the reference's, has no ``spectral-init`` span) and the fit loop, and hands the `Telemetry` to `fit_loop`,
which records the iterations.
"""
from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.core.affinities import Affinities, make_affinities
from repro_torch.core.minimize import DenseObjective
from repro_torch.core.spectral_init import laplacian_eigenmaps
from repro_torch.embed.engine import EngineResult, fit_loop, make_loop_config
from repro_torch.embed.trainer import (build_dense_mesh_objective,
                                       build_sparse_objective,
                                       build_tree_objective)
from repro_torch.obs import activate, span

from .registries import attach_backend_impl, strategy_entry


def _tracing(telemetry):
    if telemetry is None:
        return contextlib.nullcontext()
    return activate(telemetry.tracer)


def _timed(fn, device: torch.device, name: str, **args):
    """fn() and its wall-clock seconds, the device work included, under the
    phase span `name`."""
    t0 = time.perf_counter()
    with span(name, phase=True, **args):
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _dense_problem(spec, Y, X0, aff, device: torch.device):
    phase_times: dict[str, float] = {}
    if aff is None:
        if Y is None:
            raise ValueError("fit needs Y (or a precomputed aff=)")
        Yt = torch.as_tensor(Y, dtype=torch.float32, device=device)
        aff, phase_times["affinities_s"] = _timed(
            lambda: make_affinities(Yt, spec.perplexity, model=spec.kind),
            device, "graph-build", dense=True)
    else:
        aff = Affinities(*(torch.as_tensor(w, dtype=torch.float32,
                                           device=device) for w in aff))
    if X0 is None:
        X0, phase_times["spectral_init_s"] = _timed(
            lambda: laplacian_eigenmaps(aff.Wp, spec.dim) * 0.1, device,
            "spectral-init")
    X0 = torch.as_tensor(X0, dtype=torch.float32, device=device)
    return aff, X0, phase_times


def fit_dense(spec, Y, *, X0=None, aff=None, saff=None, device, mesh=None,
              mesh_spec=None, callback=None, shift_source=None,
              telemetry=None
              ) -> tuple[EngineResult, Affinities, torch.Tensor]:
    """Single-device dense backend: full affinities, any registered
    strategy, the fused step of `core/minimize.DenseObjective`.  Returns
    the engine result, the affinities and the starting point."""
    if saff is not None:
        raise ValueError("precomputed saff= is for the sparse backend (the "
                         "dense backend computes dense affinities; pass aff= "
                         "instead)")
    if shift_source is not None:
        raise ValueError("shift_source= draws the sparse backend's negatives;"
                         " the dense backend samples nothing")
    with _tracing(telemetry):
        aff, X0, phase_times = _dense_problem(spec, Y, X0, aff, device)
        strategy = strategy_entry(spec.strategy).dense_factory(
            spec, **dict(spec.strategy_opts))
        ls = spec.resolved_ls()
        lam = torch.tensor(spec.lam, dtype=X0.dtype, device=device)
        obj = DenseObjective(aff, spec.kind, lam, strategy, ls, X0,
                             impl=spec.kernel_args())
        res = fit_loop(obj, X0, make_loop_config(spec, ls), callback,
                       telemetry=telemetry)
    res.phase_times = phase_times
    return res, aff, X0


def fit_dense_mesh(spec, Y, *, X0=None, aff=None, saff=None, device,
                   mesh=None, mesh_spec=None, callback=None,
                   shift_source=None, telemetry=None
                   ) -> tuple[EngineResult, None, torch.Tensor]:
    """The dense backend with the N x N affinities 2-D-sharded over the
    ranks of `mesh` (a `launch.mesh.Mesh`) and the block-Jacobi spectral
    direction; every rank calls it with the same arguments and gets the
    same result.  Returns the engine result, None (each rank keeps only its
    tile of the affinities) and the starting point."""
    if aff is not None:
        raise ValueError("precomputed aff= is dense-backend-only (the mesh "
                         "backend shards its own affinities)")
    if saff is not None:
        raise ValueError(
            "precomputed saff= is for the sparse/tree backends (the "
            "dense-mesh backend computes dense affinities; pass aff= "
            "instead)")
    if shift_source is not None:
        raise ValueError("shift_source= draws the sparse backend's negatives;"
                         " the dense-mesh backend samples nothing")
    if Y is None:
        raise ValueError("fit needs Y")
    if mesh is None:
        raise ValueError("the dense-mesh backend needs a mesh")
    phase_times: dict[str, float] = {}
    with _tracing(telemetry):
        obj, X0 = build_dense_mesh_objective(
            spec, mesh, mesh_spec, Y, X0, strategy=spec.strategy,
            device=device, phase_times=phase_times)
        res = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()),
                       callback, telemetry=telemetry)
    res.phase_times = phase_times
    return res, None, X0


def fit_sparse(spec, Y, *, X0=None, aff=None, saff=None, device, mesh=None,
               mesh_spec=None, callback=None, shift_source=None,
               telemetry=None
               ) -> tuple[EngineResult, object, torch.Tensor]:
    """Single-device sparse backend: ELL affinities, negative-sampled
    repulsion, matrix-free sd/fp/gd directions.  Returns the engine result,
    the `SparseAffinities` and the starting point; `phase_times` holds the
    graph build's steps and the spectral start (those skipped are absent).
    """
    if aff is not None:
        raise ValueError("precomputed aff= is dense-backend-only (the sparse "
                         "backend builds its own ELL graph; pass saff= for a "
                         "precomputed one)")
    if Y is None and saff is None:
        raise ValueError("fit needs Y (or a precomputed saff=)")
    phase_times: dict[str, float] = {}
    with _tracing(telemetry):
        obj, X0, saff = build_sparse_objective(
            spec, Y, X0, strategy=spec.strategy, saff=saff, device=device,
            shift_source=shift_source, phase_times=phase_times)
        res = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()),
                       callback, telemetry=telemetry)
    res.phase_times = phase_times
    return res, saff, X0


def fit_sparse_sharded(spec, Y, *, X0=None, aff=None, saff=None, device,
                       mesh=None, mesh_spec=None, callback=None,
                       shift_source=None, telemetry=None
                       ) -> tuple[EngineResult, object, torch.Tensor]:
    """The sparse backend with the ELL graph row-sharded over the ranks of
    `mesh` (a `launch.mesh.Mesh`); every rank calls it with the same
    arguments and gets the same result.  Returns as `fit_sparse` does."""
    if aff is not None:
        raise ValueError("precomputed aff= is dense-backend-only (the "
                         "sparse backend builds its own ELL graph; pass "
                         "saff= for a precomputed one)")
    if saff is not None:
        raise ValueError(
            "precomputed saff= is not supported on the sparse-sharded "
            "backend yet (the shards are cut from the build); use the "
            "sparse or tree backend")
    if Y is None:
        raise ValueError("fit needs Y")
    phase_times: dict[str, float] = {}
    with _tracing(telemetry):
        obj, X0, saff = build_sparse_objective(
            spec, Y, X0, strategy=spec.strategy, sharded=True,
            device=device, mesh=mesh, mspec=mesh_spec,
            shift_source=shift_source, phase_times=phase_times)
        res = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()),
                       callback, telemetry=telemetry)
    res.phase_times = phase_times
    return res, saff, X0


def fit_tree(spec, Y, *, X0=None, aff=None, saff=None, device, mesh=None,
             mesh_spec=None, callback=None, shift_source=None,
             telemetry=None
             ) -> tuple[EngineResult, object, torch.Tensor]:
    """Single-device deterministic Barnes-Hut backend: exact ELL attractive
    terms plus grid far-field repulsion, O(N log N), 2-D only, bit-identical
    across repeated runs.  Returns as `fit_sparse` does."""
    if aff is not None:
        raise ValueError("precomputed aff= is dense-backend-only (the tree "
                         "backend builds its own ELL graph; pass saff= for a "
                         "precomputed one)")
    if shift_source is not None:
        raise ValueError("shift_source= draws the sparse backend's negatives;"
                         " the tree backend samples nothing")
    if Y is None and saff is None:
        raise ValueError("fit needs Y (or a precomputed saff=)")
    phase_times: dict[str, float] = {}
    with _tracing(telemetry):
        obj, X0, saff = build_tree_objective(
            spec, Y, X0, strategy=spec.strategy, saff=saff, device=device,
            phase_times=phase_times)
        res = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()),
                       callback, telemetry=telemetry)
    res.phase_times = phase_times
    return res, saff, X0


attach_backend_impl("dense", fit_dense)
attach_backend_impl("dense-mesh", fit_dense_mesh)
attach_backend_impl("sparse", fit_sparse)
attach_backend_impl("sparse-sharded", fit_sparse_sharded)
attach_backend_impl("tree", fit_tree)
