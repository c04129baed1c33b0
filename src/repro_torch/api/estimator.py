"""`Embedding`: the public estimator of the port.

Port of `Embedding.fit` / `fit_transform` from `repro/api/estimator.py`:

    from repro_torch.api import Embedding, EmbedSpec

    emb = Embedding(EmbedSpec(kind="tsne", strategy="sd", lam=1.0))
    X = emb.fit_transform(Y)           # on the GPU

The estimator runs on CUDA unless it is built with ``device="cpu"``; with
no device and no CUDA it raises rather than fall back to the CPU.  The
``sparse-sharded`` backend runs under a `torch.distributed` process group,
one process per rank, each calling `fit` with the same arguments:

    torch.cuda.set_device(local_rank)              # e.g. under torchrun
    torch.distributed.init_process_group("nccl")
    emb = Embedding(EmbedSpec(backend="sparse-sharded")).fit(Y)

`mesh=` (a `launch.mesh.Mesh`; by default the whole group on the row axis)
and `mesh_spec=` (an `embed.distributed.EmbedMeshSpec`) matter to that
backend only.  After `fit`:

  * `embedding_`   — the (N, dim) embedding, a tensor on the device
  * `result_`      — the full `EngineResult` (energies, times, fevals, ...)
  * `backend_`     — the resolved backend name
  * `affinities_`  — the affinities the fit used (computed or passed):
                     `core.Affinities` (dense) or
                     `sparse.SparseAffinities` (sparse, tree)
  * `X0_`          — the starting point the fit used
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.launch.mesh import make_host_mesh, world_size

from . import registries
from .spec import EmbedSpec


def resolve_device(device) -> torch.device:
    """``None`` means this process's current CUDA device (under a process
    group, the rank's: set it with `torch.cuda.set_device`), which must
    then be available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class Embedding:
    """Estimator facade: `EmbedSpec` in, embedding out.  Keyword overrides
    construct or derive the spec: `Embedding(kind="tsne", lam=1.0)` ==
    `Embedding(EmbedSpec(kind="tsne", lam=1.0))`."""

    def __init__(self, spec: EmbedSpec | None = None, *, device=None,
                 mesh=None, mesh_spec=None, **overrides):
        if spec is None:
            spec = EmbedSpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        self.spec = spec
        self.device = resolve_device(device)
        self.mesh = mesh
        self.mesh_spec = mesh_spec

    def _resolve_backend(self, n: int) -> str:
        n_devices = self.mesh.size if self.mesh is not None else world_size()
        return registries.resolve_backend(
            self.spec.backend, n=n, n_devices=n_devices,
            strategy=self.spec.strategy)

    def _mesh_for(self, backend: str):
        """The mesh of a mesh backend: the one given, else the default
        process group's (which must be started)."""
        if registries.BACKENDS[backend].needs_mesh and self.mesh is None:
            self.mesh = make_host_mesh()
        return self.mesh

    def fit(self, Y, X0=None, aff=None,
            callback: Callable[..., None] | None = None, *, saff=None,
            shift_source=None) -> "Embedding":
        """Fit the embedding.  `Y` is the (N, D) data (array or tensor); the
        dense backend alternatively accepts precomputed `aff=`
        (`core.Affinities`) and the sparse and tree backends `saff=`
        (`sparse.SparseAffinities`), so that several fits share one
        calibration; under ``backend="auto"`` a `saff=` pins the sparse
        backend.  `X0` replaces the spectral start.  `shift_source(seed,
        it)` replaces the sparse backend's draw of iteration `it`'s
        negative shifts ((n_negatives,) ints in 1..N-1)."""
        if aff is not None and saff is not None:
            raise ValueError("pass aff= (dense) or saff= (sparse), not both "
                             "- they pin different backends")
        if Y is not None:
            n = Y.shape[0]
        elif aff is not None:
            n = aff.Wp.shape[0]
        elif saff is not None:
            n = saff.graph.n
        else:
            raise ValueError("fit needs Y (or a precomputed aff= or saff=)")
        if aff is not None and self.spec.backend == "auto":
            backend = "dense"   # only the dense path consumes dense aff=
        elif saff is not None and self.spec.backend == "auto":
            backend = "sparse"  # an ELL graph: sparse, unless tree is named
        else:
            backend = self._resolve_backend(n)
        registries.validate_strategy_backend(self.spec.strategy, backend)
        fit_fn = registries.backend_impl(backend)
        res, aff, X0 = fit_fn(self.spec, Y, X0=X0, aff=aff, saff=saff,
                              device=self.device,
                              mesh=self._mesh_for(backend),
                              mesh_spec=self.mesh_spec, callback=callback,
                              shift_source=shift_source)
        self.backend_ = backend
        self.result_ = res
        self.embedding_ = res.X
        self.affinities_ = aff
        self.X0_ = X0
        return self

    def fit_transform(self, Y, X0=None, callback=None) -> torch.Tensor:
        return self.fit(Y, X0=X0, callback=callback).embedding_

    def __repr__(self):
        fitted = getattr(self, "backend_", None)
        state = f"fitted[{fitted}]" if fitted else "unfitted"
        return (f"Embedding(kind={self.spec.kind!r}, "
                f"strategy={self.spec.strategy!r}, "
                f"backend={self.spec.backend!r}, device={str(self.device)!r}, "
                f"{state})")
