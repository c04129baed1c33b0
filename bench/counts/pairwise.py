"""Kernel 1, the dense pairwise terms (L(a) X, L(b) X, E+ and s) of one
evaluation: the two N x N weight matrices and X read once, the two (N, d)
outputs and two scalars written once, FLOPS_PER_PAIR operations a pair at
d = 2 (difference and square per dimension, the kernel value, the
weights, six accumulations; a transcendental call counts one)."""
FLOPS_PER_PAIR = 25


def work(n: int, d: int, storage_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one evaluation."""
    nbytes = 2 * n * n * storage_bytes + n * d * storage_bytes + 2 * n * d * 4 + 8
    return float(FLOPS_PER_PAIR * n * n), float(nbytes)
