"""The plain reference: straightforward float64 PyTorch of the paper's
algorithms, one piece a file, independent of the program under test.

Nothing here imports `jax`, the JAX package or anything of `repro_torch`.
The pieces are handed the benchmark's data and work out everything else
again: affinities, graphs, operators, directions and energies.  Where the
program's algorithm is a fixed procedure (the random-projection kNN
windows, the cyclic-shift negatives, the calibration, the block power
iteration, the line search), the piece is a frozen copy of that procedure,
with its draws remade from the same seeds.  The program's outputs enter
only to be judged (`backend_*.judge`); the one exception is named there:
the reference's trajectory starts from the program's spectral start, which
is checked on its own first."""

import importlib
import importlib.util


def direction_module(strategy: str, backend: str):
    """The reference's direction of `strategy`: its backend's own piece
    (`direction_<strategy>_<backend>`) where the backends differ, else the
    one piece all backends share (`direction_<strategy>`)."""
    name = f"reference.direction_{strategy}_{backend}"
    if importlib.util.find_spec(name) is None:
        name = f"reference.direction_{strategy}"
    return importlib.import_module(name)
