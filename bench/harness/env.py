"""Where a run may write, the environment it sets up before it imports the
program, and the two refusals that print no result: no card, or a module
of JAX (or the JAX package) loaded in this process."""
from __future__ import annotations

import os
import sys
from pathlib import Path

#: the checkout: bench/harness/env.py -> parents[2]
ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
#: every cache the program keeps, at fixed paths inside the checkout
CACHE = ROOT / "build" / "bench"

#: top-level module names that may not be loaded in the process that prints
#: a result, compared whole (the port's name begins with the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


class Refusal(Exception):
    """A run that must end without a result line: the message goes to
    standard error and the exit code is not 0."""


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout, set before the program
    or PyTorch is imported: the launch-shape cache of `kernels/autotune.py`
    (`REPRO_AUTOTUNE_CACHE`), and PyTorch's extension and Triton caches in
    case a library reaches for them.  The kernels' own libraries go to
    `build/repro_torch_kernels/` inside the checkout (`kernels/_build.py`)."""
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def import_program():
    """Put the checkout's `src/` first on the path and import the system
    under test; a checkout that holds only the benchmark has no program and
    is refused."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise Refusal(f"the program under test is missing: no "
                      f"{src / 'repro_torch'} in this checkout")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch.api  # noqa: F401
    return repro_torch


def check_devices(chips: int) -> None:
    """Refuse unless CUDA is available with at least `chips` cards."""
    import torch
    if not torch.cuda.is_available():
        raise Refusal("torch.cuda.is_available() is false: this benchmark "
                      "measures the port on a CUDA device and prints no "
                      "result without one")
    have = torch.cuda.device_count()
    if have < chips:
        raise Refusal(f"the cell asks for {chips} CUDA devices and "
                      f"torch.cuda.device_count() is {have}")


def forbidden_modules_loaded() -> list[str]:
    """The loaded modules whose top-level name is forbidden, compared
    whole: `repro_torch` is allowed, `repro` and `repro.core` are not."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN_MODULES)
