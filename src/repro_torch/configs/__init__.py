from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig
from .registry import (ARCH_IDS, EMBEDDING_ARCHS, get_config,
                       get_smoke_config, shape_cells, skipped_cells)

__all__ = ["SHAPES", "ModelConfig", "RunConfig", "ShapeConfig", "ARCH_IDS",
           "EMBEDDING_ARCHS", "get_config", "get_smoke_config",
           "shape_cells", "skipped_cells"]
