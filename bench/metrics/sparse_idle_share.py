"""`idle_share` of the sparse cells, which report `sparse_iter_ms`: the same
reading (`metrics/idle_share.py`) under the name of their own end-to-end metric."""
from metrics.idle_share import read  # noqa: F401
