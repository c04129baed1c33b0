"""Put `bench/` on the path (its packages import as `harness`, `reference`,
`counts`) and give the tests that need the card a fixture that decides,
when the test runs, whether there is one."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chip)")
    return torch.device("cuda")
