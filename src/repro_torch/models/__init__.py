from .model import Model, block_pattern, build_model
from .train import make_decode_step, make_prefill

__all__ = ["Model", "build_model", "block_pattern", "make_decode_step",
           "make_prefill"]
