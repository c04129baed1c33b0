"""`Embedding`: the public estimator of the port.

Port of `Embedding.fit` / `fit_transform` from `repro/api/estimator.py`:

    from repro_torch.api import Embedding, EmbedSpec

    emb = Embedding(EmbedSpec(kind="tsne", strategy="sd", lam=1.0))
    X = emb.fit_transform(Y)           # on the GPU

The estimator runs on CUDA unless it is built with ``device="cpu"``; with
no device and no CUDA it raises rather than fall back to the CPU.  The
mesh backends, ``dense-mesh`` and ``sparse-sharded``, run under a
`torch.distributed` process group, one process per rank, each calling `fit`
with the same arguments:

    torch.cuda.set_device(local_rank)              # e.g. under torchrun
    torch.distributed.init_process_group("nccl")
    emb = Embedding(EmbedSpec(backend="dense-mesh"),
                    mesh=make_host_mesh(model_axis=2)).fit(Y)

`mesh=` (a `launch.mesh.Mesh`; by default the whole group on the row axis,
`make_host_mesh()`) and `mesh_spec=` (an `embed.distributed.EmbedMeshSpec`:
the row axes that split the rows of the dense affinities, or the sparse
graph's, and the column axis that splits the dense affinities' columns; by
default every mesh axis but the last, and the last) matter to those
backends only.  With several ranks and N <= 2048 divisible by their count,
``backend="auto"`` picks ``dense-mesh``.  After `fit`:

  * `embedding_`   — the (N, dim) embedding, a tensor on the device
  * `result_`      — the full `EngineResult` (energies, times, fevals, ...)
  * `backend_`     — the resolved backend name
  * `affinities_`  — the affinities the fit used (computed or passed):
                     `core.Affinities` (dense),
                     `sparse.SparseAffinities` (sparse, sparse-sharded,
                     tree), or None (dense-mesh: no rank keeps them whole)
  * `X0_`          — the starting point the fit used
  * `telemetry_`   — the finalized `obs.Telemetry` of a fit run with
                     `telemetry=` (None otherwise)

`resume()` continues a fit from `spec.checkpoint_dir`: the engine's payload
carries the line-search and solver state, so the resumed trajectory is the
uninterrupted one, bit for bit.  `transform(Y_new)` embeds unseen points
against the FROZEN training embedding (api/transform.py) and leaves
`embedding_` bit-identical; `save` and the classmethod `load` move a fitted
estimator across processes as a versioned artifact (api/artifact.py, the
reference's schema v1).  Inputs may be arrays or tensors; they go to the
estimator's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.launch.mesh import make_host_mesh, world_size
from repro_torch.obs import resolve_telemetry

from . import registries
from .spec import EmbedSpec, TransformSpec
from .transform import transform_points


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
            shift_source=None, telemetry=None) -> "Embedding":
        """Fit the embedding.  `Y` is the (N, D) data (array or tensor); the
        dense backend alternatively accepts precomputed `aff=`
        (`core.Affinities`) and the sparse and tree backends `saff=`
        (`sparse.SparseAffinities`), so that several fits share one
        calibration; under ``backend="auto"`` a `saff=` pins the sparse
        backend.  `X0` replaces the spectral start.  `shift_source(seed,
        it)` replaces the sparse backend's draw of iteration `it`'s
        negative shifts ((n_negatives,) ints in 1..N-1).

        `telemetry` switches on run observability (`repro_torch.obs`):
        `True` records in memory, a directory path also writes `run.jsonl`
        and `trace.json` there, a `obs.Telemetry` gives full control.
        After the fit `telemetry_` holds it, finalized (`.summary()`,
        `.recorder.records`, ...), and `result_.diagnostics` the
        per-iteration table.  Telemetry never changes the fit's results."""
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
        tel = resolve_telemetry(telemetry)
        if tel is not None:
            tel.recorder.set_meta(backend=backend, kind=self.spec.kind,
                                  strategy=self.spec.strategy, n=int(n))
        try:
            res, aff, X0 = fit_fn(self.spec, Y, X0=X0, aff=aff, saff=saff,
                                  device=self.device,
                                  mesh=self._mesh_for(backend),
                                  mesh_spec=self.mesh_spec,
                                  callback=callback,
                                  shift_source=shift_source, telemetry=tel)
        finally:
            if tel is not None:
                tel.finalize()
        self.backend_ = backend
        self.result_ = res
        self.embedding_ = res.X
        self.affinities_ = aff
        self.X0_ = X0
        self.telemetry_ = tel
        self._Y_train = Y
        self._Y_dev = None
        return self

    def fit_transform(self, Y, X0=None, callback=None, *,
                      telemetry=None) -> torch.Tensor:
        return self.fit(Y, X0=X0, callback=callback,
                        telemetry=telemetry).embedding_

    def resume(self, Y=None, max_iters: int | None = None, *,
               telemetry=None, **fit_kw) -> "Embedding":
        """Continue a checkpointed fit from `spec.checkpoint_dir`, bit for
        bit the uninterrupted trajectory (the engine's payload carries the
        line-search and solver state).  `max_iters` extends the iteration
        budget.  The same `telemetry` directory as the interrupted fit's
        appends to its `run.jsonl`: one contiguous run of iteration records
        across the checkpoint.  `fit_kw` (`X0=`, `aff=`, `saff=`,
        `shift_source=`, `callback=`) go to `fit`, so that a resume can take
        the precomputed inputs and draws of the fit it continues."""
        if self.spec.checkpoint_dir is None:
            raise ValueError("resume() needs spec.checkpoint_dir")
        if Y is None:               # this process's fit's, if there was one
            Y = getattr(self, "_Y_train", None)
        if max_iters is not None:
            self.spec = dataclasses.replace(self.spec, max_iters=max_iters)
        return self.fit(Y, telemetry=telemetry, **fit_kw)

    # -- serving -------------------------------------------------------------
    def _train_tensor(self) -> torch.Tensor:
        """The training Y as a float32 tensor on the estimator's device
        (made once and kept)."""
        if getattr(self, "_Y_dev", None) is None:
            self._Y_dev = torch.as_tensor(self._Y_train, dtype=torch.float32,
                                          device=self.device)
        return self._Y_dev

    def transform(self, Y_new, spec: TransformSpec | None = None, *,
                  anchor_source=None, projections=None) -> torch.Tensor:
        """Embed unseen points against the frozen training embedding.

        Never re-fits: the training coordinates enter as constants, so
        `embedding_` is bit-identical before and after.  Configuration is a
        `TransformSpec`, whose zero and None fields defer to the fitted
        `EmbedSpec`.  `anchor_source(seed, it)` and `projections` replace
        the random draws (api/transform.py).  Requires the fit to have seen
        raw `Y` (not only precomputed affinities).  The result (an
        `EngineResult` or `RowwiseResult`) is kept as
        `last_transform_result_`."""
        if getattr(self, "embedding_", None) is None:
            raise ValueError("transform() requires a fitted estimator")
        if getattr(self, "_Y_train", None) is None:
            if getattr(self, "loaded_from_", None):
                raise ValueError(
                    "transform() needs the training Y: this estimator was "
                    "loaded from a train='ref' artifact whose reference was "
                    "unavailable - pass Y_train= to Embedding.load()")
            raise ValueError(
                "transform() needs the raw training Y; this estimator was "
                "fit from precomputed affinities only")
        X_new, res = transform_points(
            self.spec, self._train_tensor(), self.embedding_, Y_new,
            tspec=spec, anchor_source=anchor_source, projections=projections)
        self.last_transform_result_ = res
        return X_new

    # -- persistence ---------------------------------------------------------
    def save(self, path: str, *, train: str = "snapshot",
             train_ref: str | None = None) -> str:
        """Persist the fitted estimator as a versioned artifact (one `.npz`:
        embedding, training data, frozen spec, graph stats), the supported
        way to move a fitted `Embedding` across processes and between the
        two packages; pickling is refused.  `train='ref'` stores a path and
        SHA-256 instead of the training Y.  Returns `path`."""
        from .artifact import save_artifact
        return save_artifact(self, path, train=train, train_ref=train_ref)

    @classmethod
    def load(cls, path: str, *, Y_train=None, device=None) -> "Embedding":
        """Reload a saved artifact (the port's or the reference's) onto
        `device` (None: CUDA, which must be available): a fitted estimator
        whose exhaustive `transform()` matches the saving estimator's bit
        for bit on the same device; no refit happens."""
        from .artifact import load_artifact
        return load_artifact(path, Y_train=Y_train, device=device)

    def __reduce__(self):
        raise TypeError(
            "pickling Embedding is unsupported (device tensors and solver "
            "state do not survive it); use est.save(path) / "
            "Embedding.load(path), the versioned artifact format")

    def __repr__(self):
        loaded = getattr(self, "loaded_from_", None)
        fitted = getattr(self, "backend_", None)
        if loaded:
            ver = (getattr(self, "artifact_header_", None) or {}).get(
                "schema_version")
            state = f"loaded[v{ver}:{loaded}]"
        elif fitted:
            state = f"fitted[{fitted}]"
        else:
            state = "unfitted"
        X = getattr(self, "embedding_", None)
        if X is not None:
            state += f", n_train={X.shape[0]}"
        return (f"Embedding(kind={self.spec.kind!r}, "
                f"strategy={self.spec.strategy!r}, "
                f"backend={self.spec.backend!r}, device={str(self.device)!r}, "
                f"{state})")
