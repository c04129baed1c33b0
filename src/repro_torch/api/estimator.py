"""`Embedding`: the public estimator of the port.

Port of `Embedding.fit` / `fit_transform` from `repro/api/estimator.py`:

    from repro_torch.api import Embedding, EmbedSpec

    emb = Embedding(EmbedSpec(kind="tsne", strategy="sd", lam=1.0))
    X = emb.fit_transform(Y)           # on the GPU

The estimator runs on CUDA unless it is built with ``device="cpu"``; with
no device and no CUDA it raises rather than fall back to the CPU.  After
`fit`:

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

from . import registries
from .spec import EmbedSpec


def resolve_device(device) -> torch.device:
    """``None`` means CUDA, which must then be available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class Embedding:
    """Estimator facade: `EmbedSpec` in, embedding out.  Keyword overrides
    construct or derive the spec: `Embedding(kind="tsne", lam=1.0)` ==
    `Embedding(EmbedSpec(kind="tsne", lam=1.0))`."""

    def __init__(self, spec: EmbedSpec | None = None, *, device=None,
                 **overrides):
        if spec is None:
            spec = EmbedSpec(**overrides)
        elif overrides:
            spec = dataclasses.replace(spec, **overrides)
        self.spec = spec
        self.device = resolve_device(device)

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
            backend = registries.resolve_backend(
                self.spec.backend, n=n, strategy=self.spec.strategy)
        registries.validate_strategy_backend(self.spec.strategy, backend)
        fit_fn = registries.backend_impl(backend)
        res, aff, X0 = fit_fn(self.spec, Y, X0=X0, aff=aff, saff=saff,
                              device=self.device, callback=callback,
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
