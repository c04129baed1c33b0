# AdamW with the reference's schedule and clipping, and the int8
# error-feedback gradient compression (optim/adamw.py, optim/compress.py).
from . import adamw, compress

__all__ = ["adamw", "compress"]
