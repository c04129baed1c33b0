"""Strategy and backend registries behind `repro_torch.api.Embedding`.

Port of `repro/api/registries.py`: the paper's strategy lineup (``gd``,
``fp``, ``diag``, ``sd``, ``sd-``, and the baselines ``lbfgs`` and ``cg``;
aliases ``diagh``, ``sdminus``, ``l-bfgs`` and ``nonlinearcg``) and the
backends ``dense``, ``dense-mesh`` (the N x N affinities 2-D-sharded over
the ranks of a process group), ``sparse``, ``sparse-sharded`` (the ELL graph
row-sharded over them) and ``tree``; the two mesh backends need a mesh.
``backend="auto"`` follows the reference's policy: ``sparse`` above
AUTO_SPARSE_N points (``sparse-sharded`` when the mesh has more than one
rank), ``dense-mesh`` up to AUTO_SPARSE_N when it has several ranks and N is
divisible by their count, else ``dense``, and ``dense`` for a strategy the
size-preferred backend lacks.  ``tree`` is never picked by ``auto`` (it is
2-D only), a spec selects it by name.

Every strategy runs on ``dense``.  ``diag`` and ``sd-`` need dense Hessian
terms, and the baselines keep (N, d) histories, so they are dense-only;
``sd``, ``fp`` and ``gd`` run on every backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.core.baselines import LBFGS, NonlinearCG
from repro_torch.core.strategies import FP, GD, SD, DiagH, SDMinus

#: N above which ``backend="auto"`` picks the sparse backend
AUTO_SPARSE_N = 2048


@dataclasses.dataclass(frozen=True)
class StrategyEntry:
    """One registered search-direction strategy; `dense_factory(spec,
    **opts)` builds the `core/strategies` object of the dense backend."""

    name: str
    backends: frozenset[str]
    dense_factory: Callable[..., Any]
    default_ls_init: str = "one"   # LSConfig.init_step when EmbedSpec.ls=None
    doc: str = ""


STRATEGIES: dict[str, StrategyEntry] = {}
_STRATEGY_ALIASES: dict[str, str] = {}


def register_strategy(name: str, *, backends, dense_factory,
                      default_ls_init: str = "one", aliases=(),
                      doc: str = "") -> None:
    STRATEGIES[name] = StrategyEntry(
        name=name, backends=frozenset(backends), dense_factory=dense_factory,
        default_ls_init=default_ls_init, doc=doc)
    for a in aliases:
        _STRATEGY_ALIASES[a] = name


def available_strategies() -> list[str]:
    return sorted(STRATEGIES)


def canonical_strategy(name: str) -> str:
    """Canonical registry name (resolving aliases), or ValueError listing
    the valid names."""
    low = name.lower()
    low = _STRATEGY_ALIASES.get(low, low)
    if low not in STRATEGIES:
        raise ValueError(f"unknown strategy {name!r}; registered strategies: "
                         f"{available_strategies()}")
    return low


def strategy_entry(name: str) -> StrategyEntry:
    return STRATEGIES[canonical_strategy(name)]


@dataclasses.dataclass
class BackendEntry:
    """One registered fitting path; `fit` is attached by
    `repro_torch.api.backends` on first use."""

    name: str
    doc: str = ""
    fit: Callable[..., Any] | None = None
    needs_mesh: bool = False   # True: the estimator supplies a mesh


BACKENDS: dict[str, BackendEntry] = {}


def register_backend(name: str, *, doc: str = "", fit=None,
                     needs_mesh: bool = False) -> None:
    BACKENDS[name] = BackendEntry(name=name, doc=doc, fit=fit,
                                  needs_mesh=needs_mesh)


def attach_backend_impl(name: str, fit) -> None:
    """Attach the fit callable to an already-registered backend: the one
    registration point for name, doc and needs_mesh stays in this module;
    `repro_torch.api.backends` only supplies the implementations."""
    BACKENDS[name].fit = fit


def available_backends() -> list[str]:
    return sorted(BACKENDS)


def validate_backend(name: str) -> str:
    if name != "auto" and name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; registered backends: "
                         f"{available_backends()} (or 'auto')")
    return name


def validate_strategy_backend(strategy: str, backend: str) -> None:
    entry = strategy_entry(strategy)
    if backend != "auto" and backend not in entry.backends:
        raise ValueError(
            f"strategy {entry.name!r} is not available on backend "
            f"{backend!r}; it runs on {sorted(entry.backends)}")


def backend_impl(name: str):
    """The backend's fit callable (importing `repro_torch.api.backends` on
    first use, which attaches the implementations)."""
    entry = BACKENDS[validate_backend(name)]
    if entry.fit is None:
        import repro_torch.api.backends  # noqa: F401  (attaches fit)
    return BACKENDS[name].fit


def resolve_backend(backend: str, *, n: int, n_devices: int = 1,
                    strategy: str) -> str:
    """``auto`` policy: sparse above AUTO_SPARSE_N points, mesh-sharded when
    the mesh has more than one rank (`n_devices`); ``dense`` when the
    size-preferred backend cannot realize the requested strategy, or when
    the dense-mesh (N, N) sharding needs N divisible by the rank count and
    it isn't (the sparse-sharded backend pads rows instead)."""
    if backend != "auto":
        return validate_backend(backend)
    multi = n_devices > 1
    if n > AUTO_SPARSE_N:
        name = "sparse-sharded" if multi else "sparse"
    else:
        name = "dense-mesh" if multi and n % n_devices == 0 else "dense"
    if name not in strategy_entry(strategy).backends:
        name = "dense"               # every registered strategy runs dense
    return name


_BACKENDS = ("dense", "dense-mesh", "sparse", "sparse-sharded", "tree")

register_backend("dense", doc="single device, full affinities, fused step "
                              "(core/minimize.py)")
register_backend("dense-mesh", needs_mesh=True,
                 doc="2-D-sharded affinities + block-Jacobi solves over the "
                     "ranks of a torch.distributed process group "
                     "(embed/trainer.py)")
register_backend("sparse", doc="single device, ELL neighbour graph + "
                               "negative sampling, Jacobi-PCG "
                               "(embed/trainer.py)")
register_backend("sparse-sharded", needs_mesh=True,
                 doc="the sparse backend with the ELL graph row-sharded over "
                     "the ranks of a torch.distributed process group "
                     "(sparse/sharding.py)")
register_backend("tree", doc="single device, deterministic Barnes-Hut grid "
                             "repulsion, O(N log N), 2-D only "
                             "(sparse/farfield.py)")

register_strategy("gd", backends=_BACKENDS,
                  dense_factory=lambda spec, **o: GD(**o),
                  doc="gradient descent: B = I")
register_strategy("fp", backends=_BACKENDS,
                  dense_factory=lambda spec, **o: FP(**o),
                  doc="diagonal fixed-point: B = 4 D+ (x) I_d")
register_strategy("sd", backends=_BACKENDS, default_ls_init="adaptive_grow",
                  dense_factory=lambda spec, **o: SD(**{"mu_scale":
                                                        spec.mu_scale, **o}),
                  doc="the spectral direction: B = 4 L+ + mu I (paper "
                      "headline)")
register_strategy("diag", backends=("dense",), aliases=("diagh",),
                  dense_factory=lambda spec, **o: DiagH(**o),
                  doc="clipped diagonal of the full Hessian (needs dense "
                      "terms)")
register_strategy("sd-", backends=("dense",), aliases=("sdminus",),
                  default_ls_init="adaptive_grow",
                  dense_factory=lambda spec, **o: SDMinus(**o),
                  doc="SD plus psd repulsive curvature blocks (batched CG)")
# quasi-Newton baselines from the paper's comparison lineup
register_strategy("lbfgs", backends=("dense",), aliases=("l-bfgs",),
                  dense_factory=lambda spec, **o: LBFGS(**o),
                  doc="limited-memory BFGS baseline")
register_strategy("cg", backends=("dense",), aliases=("nonlinearcg",),
                  dense_factory=lambda spec, **o: NonlinearCG(**o),
                  doc="nonlinear conjugate-gradient baseline")
