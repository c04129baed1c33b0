"""`EmbedSpec` and `TransformSpec`: the declarative descriptions of an
embedding problem and of an out-of-sample transform request.

Port of `repro/api/spec.py`.  `EmbedSpec` holds the model `kind`,
`strategy`, `backend`, the objective and loop settings, the sparse
neighbour-graph knobs, the out-of-sample transform's defaults, the
Barnes-Hut tree knobs, kernel dispatch and checkpointing
(`checkpoint_dir`, `checkpoint_every`: `Embedding.resume`); the names that
select what runs are validated at construction.  `TransformSpec` configures
`Embedding.transform` and the server (`repro_torch.serve`); its zero and
None fields defer to the fitted `EmbedSpec`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from repro_torch.core.linesearch import LSConfig
from repro_torch.kernels.ops import IMPLS, STORAGE_DTYPES
from repro_torch.kernels.ref import KINDS

from . import registries


def validate_kind(kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; supported model families: "
                         f"{sorted(KINDS)}")
    return kind


@dataclasses.dataclass(frozen=True)
class EmbedSpec:
    """Declarative embedding problem: model x strategy x backend + knobs.

    `ls=None` resolves to the strategy's default initial-step policy
    (``adaptive_grow`` for SD, ``one`` otherwise).  `strategy_opts` is
    forwarded to the strategy factory (e.g. ``{"kappa": 7}`` for sparsified
    SD).  `kernel_impl` selects the kernel path (`kernels.ops`): ``auto``
    (the CUDA kernel on CUDA, the oracle on CPU), ``kernel`` or ``torch``.
    """

    kind: str = "ee"
    strategy: str = "sd"
    backend: str = "auto"
    lam: float = 100.0
    perplexity: float = 20.0
    dim: int = 2
    max_iters: int = 200
    tol: float = 1e-7
    mu_scale: float = 1e-5
    ls: LSConfig | None = None
    checkpoint_dir: str | None = None    # fit_loop checkpoints here
    checkpoint_every: int = 50           # iterations between checkpoints
    seed: int = 0                        # the sparse backend's draws
    max_seconds: float | None = None
    strategy_opts: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # sparse neighbour-graph knobs
    n_neighbors: int = 0          # ELL width k; 0 => auto (3 * perplexity)
    n_negatives: int = 5          # uniform negative samples per point
    z_ema_decay: float = 0.9      # streaming partition-function EMA
    knn_method: str = "auto"      # 'exact' | 'approx' | 'auto'
    cg_tol: float = 1e-3
    cg_maxiter: int = 100
    # out-of-sample transform() (api/transform.py)
    transform_iters: int = 100
    transform_negatives: int = 50  # anchor negatives per application
    kernel_impl: str = "auto"
    kernel_precision: str = "float32"    # storage; accumulation is float32
    # Barnes-Hut tree backend
    theta: float = 0.5            # opening criterion; 0 = exact (O(N^2))
    tree_depth: int = 0           # finest grid level; 0 => auto (log4 N/4)
    tree_cap: int = 0             # listed near-field slots; 0 => auto

    def __post_init__(self):
        validate_kind(self.kind)
        object.__setattr__(
            self, "strategy", registries.canonical_strategy(self.strategy))
        registries.validate_backend(self.backend)
        registries.validate_strategy_backend(self.strategy, self.backend)
        if self.kernel_impl not in IMPLS:
            raise ValueError(f"unknown kernel_impl {self.kernel_impl!r}; "
                             f"have {IMPLS}")
        if self.kernel_precision not in STORAGE_DTYPES:
            raise ValueError(f"unknown kernel_precision "
                             f"{self.kernel_precision!r}; have "
                             f"{STORAGE_DTYPES}")
        if not 0.0 <= self.theta <= 1.0:
            raise ValueError(
                f"theta must be in [0, 1] (the Barnes-Hut opening "
                f"criterion; 0 = exact), got {self.theta!r}")
        for name in ("tree_depth", "tree_cap"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"EmbedSpec.{name} must be a non-negative int "
                    f"(0 = auto), got {v!r}")

    def kernel_args(self) -> dict:
        """The `kernels.ops` dispatch kwargs this spec selects (empty at the
        defaults)."""
        out: dict = {}
        if self.kernel_impl != "auto":
            out["impl"] = self.kernel_impl
        if self.kernel_precision != "float32":
            out["storage_dtype"] = self.kernel_precision
        return out

    def resolved_ls(self) -> LSConfig:
        """The line-search config, with the strategy's default initial-step
        policy filled in when `ls` is None."""
        if self.ls is not None:
            return self.ls
        entry = registries.strategy_entry(self.strategy)
        return LSConfig(init_step=entry.default_ls_init)

    def replace(self, **changes) -> "EmbedSpec":
        return dataclasses.replace(self, **changes)


#: valid `TransformSpec.knn_method` names (cross-kNN dispatch,
#: sparse/graph.py::knn_cross)
TRANSFORM_KNN_METHODS = ("exact", "approx", "auto")
#: valid `TransformSpec.solver` names: 'engine' runs the fixed-anchor
#: objective through the shared fit_loop (one global line search over the
#: whole query batch); 'rowwise' runs the per-row solver whose results do
#: not depend on the batch's other rows, which the server requires.
TRANSFORM_SOLVERS = ("engine", "rowwise")


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """Declarative out-of-sample transform request, mirroring `EmbedSpec`:
    every serving knob, validated at construction; the frozen value is
    also the server's per-request configuration
    (`repro_torch.serve.EmbeddingServer`).  Zero and None fields defer to
    the fitted `EmbedSpec` (`max_iters=0` -> `transform_iters`,
    `n_negatives=0` -> `transform_negatives`, `k_cross=0` -> the training
    ELL width, `tol=None` -> `spec.tol`).
    """

    max_iters: int = 0            # 0 => EmbedSpec.transform_iters
    k_cross: int = 0              # 0 => EmbedSpec.n_neighbors (or 3*perp)
    n_negatives: int = 0          # 0 => EmbedSpec.transform_negatives
    exhaustive: bool = False      # deterministic repulsion over every
                                  # training anchor (per-point Z summed
                                  # over all of them)
    knn_method: str = "auto"      # cross-kNN: 'exact'|'approx'|'auto'
    solver: str = "engine"        # 'engine' | 'rowwise' (batch-invariant)
    batch_size: int = 0           # rowwise chunking cap; 0 => one batch
    tol: float | None = None      # None => EmbedSpec.tol
    seed: int = 0                 # negative-anchor draw (sampled mode)
    # approx cross-kNN knobs (sparse/graph.py::knn_cross_approx)
    n_projections: int = 8
    window: int = 16

    def __post_init__(self):
        if self.knn_method not in TRANSFORM_KNN_METHODS:
            raise ValueError(
                f"unknown knn_method {self.knn_method!r}; supported "
                f"cross-kNN methods: {list(TRANSFORM_KNN_METHODS)}")
        if self.solver not in TRANSFORM_SOLVERS:
            raise ValueError(
                f"unknown solver {self.solver!r}; supported transform "
                f"solvers: {list(TRANSFORM_SOLVERS)}")
        for name in ("max_iters", "k_cross", "n_negatives", "batch_size"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"TransformSpec.{name} must be a non-negative int "
                    f"(0 defers to the fitted EmbedSpec), got {v!r}")
        for name in ("n_projections", "window"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"TransformSpec.{name} must be a positive int, "
                    f"got {v!r}")
        if self.tol is not None and self.tol < 0:
            raise ValueError(f"TransformSpec.tol must be >= 0 or None, "
                             f"got {self.tol!r}")

    def replace(self, **changes) -> "TransformSpec":
        return dataclasses.replace(self, **changes)
