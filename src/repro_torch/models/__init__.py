from .model import Model, block_pattern, build_model
from .train import (init_train_state, make_decode_step, make_prefill,
                    make_train_step, params_specs, train_state_specs)

__all__ = ["Model", "build_model", "block_pattern", "init_train_state",
           "make_decode_step", "make_prefill", "make_train_step",
           "params_specs", "train_state_specs"]
