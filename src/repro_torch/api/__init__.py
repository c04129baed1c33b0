# The public entry point for fitting and serving embeddings with the port: a
# declarative EmbedSpec, the Embedding estimator (fit / fit_transform /
# transform / save / load), a frozen TransformSpec for the out-of-sample
# path, versioned fitted artifacts (api/artifact.py, the reference's schema
# v1) and the strategy and backend registries.  Port of repro.api for the
# dense, dense-mesh, sparse, sparse-sharded and tree backends.
from .artifact import load_artifact, read_header, save_artifact
from .estimator import Embedding
from .registries import (
    available_backends,
    available_strategies,
    register_backend,
    register_strategy,
    resolve_backend,
)
from .spec import EmbedSpec, TransformSpec
from .transform import (
    RowwiseResult,
    TransformObjective,
    resolve_transform_spec,
    transform_points,
)

__all__ = [
    "Embedding", "EmbedSpec", "TransformSpec",
    "available_backends", "available_strategies",
    "register_backend", "register_strategy", "resolve_backend",
    "TransformObjective", "transform_points", "RowwiseResult",
    "resolve_transform_spec",
    "save_artifact", "load_artifact", "read_header",
]
