"""RPR007 fixture: span() called but not used as a context manager."""
from repro_torch.obs import span


def run(step):
    span("solve-iter", it=1)                                 # RPR007
    with span("solve-iter", it=2):
        step()
