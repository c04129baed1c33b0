"""The dense SD direction: one triangular solve with the N x N factor
reads the factor's triangle once and its (N, d) right-hand side, and
writes the (N, d) solution; a multiply-add for each stored entry and
column.  The direction is `2 (1 + refine)` such solves (a Cholesky solve
is two; each step of iterative refinement adds one Cholesky solve and one
product with B, which reads B once).  Each fit factors B once: forming B
from W+ (read W+, write B) and the factor (read B, write the triangle,
N^3 / 3 multiply-adds)."""


def solve(n: int, d: int) -> tuple[float, float]:
    return float(n * n * d), float(n * (n + 1) // 2 * 4 + 2 * n * d * 4)


def direction(n: int, d: int, refine: int = 1) -> tuple[float, float]:
    f, b = solve(n, d)
    k = 2 * (1 + refine)
    return k * f + refine * 2.0 * n * n * d, k * b + refine * (n * n * 4.0)


def factor(n: int) -> tuple[float, float]:
    return n ** 3 / 3.0, float(2 * n * n * 4 + n * (n + 1) // 2 * 4)
