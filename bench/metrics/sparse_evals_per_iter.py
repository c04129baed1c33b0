"""`evals_per_iter` of the sparse cells, which report `sparse_iter_ms`: the same
reading (`metrics/evals_per_iter.py`) under the name of their own end-to-end metric."""
from metrics.evals_per_iter import read  # noqa: F401
