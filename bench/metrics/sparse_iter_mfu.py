"""`iter_mfu` of the sparse cells, which report `sparse_iter_ms`: the same
reading (`metrics/iter_mfu.py`) under the name of their own end-to-end metric."""
from metrics.iter_mfu import read  # noqa: F401
