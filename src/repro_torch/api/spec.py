"""`EmbedSpec`: the declarative description of an embedding problem.

Port of `EmbedSpec` from `repro/api/spec.py`: model `kind`, `strategy`,
`backend`, the objective and loop settings, the sparse neighbour-graph
knobs, the Barnes-Hut tree knobs and kernel dispatch.  The names that select
what runs are validated at construction.  The knobs of the parts not yet
ported (out-of-sample transform, checkpoint cadence) are absent;
`convert.spec_from_jax_fields` drops them when carrying a `repro` spec
across.
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
    checkpoint_dir: str | None = None    # not ported: must stay None
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
    kernel_impl: str = "auto"
    kernel_precision: str = "float32"    # storage; accumulation is float32
    # Barnes-Hut tree backend
    theta: float = 0.5            # opening criterion; 0 = exact (O(N^2))
    tree_depth: int = 0           # finest grid level; 0 => auto (log4 N/4)
    tree_cap: int = 0             # listed near-field slots; 0 => auto

    def __post_init__(self):
        validate_kind(self.kind)
        if self.checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint/resume is not ported to repro_torch yet")
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
