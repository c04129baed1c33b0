"""The sparse backend's pieces over ELL graphs, counted over LIVE slots
(nonzero weight), never the padding.

`product`: one directed ELL Laplacian product reads each live slot's
index and weight once, X once, and writes (N, d) once.
`pcg_iteration`: one operator application (the forward and the reverse
product) plus the CG vector updates: x, r, p and z, two dot products, the
residual norm, the shift and the Jacobi diagonal, 18 passes over (N, d)
and two over (N,).
`evaluation`: one energy (and, `with_grad`, gradient) of the sampled
objective: the forward graph's live slots, for the gradient also the
reverse graph's, X read once, G written once; the negatives are computed
from the shifts and store nothing."""


def product(n: int, d: int, live: int) -> tuple[float, float]:
    return float(2 * live * d + 2 * n * d), float(live * 8 + 2 * n * d * 4)


def pcg_iteration(n: int, d: int, live_f: int, live_r: int
                  ) -> tuple[float, float]:
    f1, b1 = product(n, d, live_f)
    f2, b2 = product(n, d, live_r)
    return (f1 + f2 + 14.0 * n * d,
            b1 + b2 + 18.0 * n * d * 4 + 2.0 * n * 4)


def evaluation(n: int, d: int, live_f: int, live_r: int, m: int,
               with_grad: bool) -> tuple[float, float]:
    slots = live_f + (live_r if with_grad else 0)
    flops = 12.0 * (slots + n * m * (2 if with_grad else 1))
    nbytes = slots * 8 + n * d * 4 * (2 if with_grad else 1)
    return flops, float(nbytes)
