# The public entry point for fitting embeddings with the port: a declarative
# EmbedSpec, the Embedding estimator (fit / fit_transform) and the strategy
# and backend registries.  Port of repro.api for the dense, sparse, tree and
# sparse-sharded backends (not yet dense-mesh).
from .estimator import Embedding
from .registries import (
    available_backends,
    available_strategies,
    register_backend,
    register_strategy,
    resolve_backend,
)
from .spec import EmbedSpec

__all__ = [
    "Embedding", "EmbedSpec",
    "available_backends", "available_strategies",
    "register_backend", "register_strategy", "resolve_backend",
]
