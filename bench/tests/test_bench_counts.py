"""Each work count against bytes and operations worked out by hand at a
small size."""
from counts import ell, iteration, pairwise, peaks, triangular


def test_pairwise():
    # N = 10, d = 2, float32: Wa and Wb 2 * 100 * 4, X 20 * 4, la and lb
    # 2 * 20 * 4, two scalars 8
    assert pairwise.work(10, 2) == (2500.0, 800 + 80 + 160 + 8)
    assert pairwise.work(10, 2, storage_bytes=2) == (2500.0, 400 + 40 + 160 + 8)


def test_triangular():
    # one solve: the triangle 55 entries * 4, the RHS and the answer 2 * 20 * 4
    assert triangular.solve(10, 2) == (200.0, 220 + 160)
    # refine = 1: four solves and one product with B (100 * 4 bytes)
    assert triangular.direction(10, 2, refine=1) == (4 * 200.0 + 400,
                                                     4 * 380 + 400)
    assert triangular.factor(10) == (1000 / 3, 800 + 220)


def test_ell():
    # 30 live slots at 8 bytes, X read and L X written: 2 * 10 * 2 * 4
    assert ell.product(10, 2, 30) == (2 * 30 * 2 + 40.0, 240 + 160.0)
    f, b = ell.pcg_iteration(10, 2, 30, 50)
    assert b == (240 + 160) + (400 + 160) + 18 * 80 + 80
    assert ell.evaluation(10, 2, 30, 50, 5, True)[1] == 80 * 8 + 160
    assert ell.evaluation(10, 2, 30, 50, 5, False)[1] == 30 * 8 + 80


def test_iteration_dense_sd():
    ctx = {"n": 10, "d": 2, "graph": {},
           "fit": {"n_iters": 4, "n_fevals": [1, 4, 7, 10, 13]},
           "config": {"spec": {"backend": "dense"}},
           "traffic": {"spec": {"strategy": "sd"}}}
    flops, nbytes = iteration.work(ctx)
    fe, be = pairwise.work(10, 2)
    fd, bd = triangular.direction(10, 2, 1)
    f0, b0 = triangular.factor(10)
    assert flops == (13 * fe + 4 * fd + f0) / 4
    assert nbytes == (13 * be + 4 * bd + b0) / 4


def test_iteration_sparse_sd_needs_pcg_counts():
    ctx = {"n": 10, "d": 2, "graph": {"live_forward": 30, "live_reverse": 50},
           "fit": {"n_iters": 2, "n_fevals": [1, 3, 5],
                   "diagnostics": [{"pcg_iters": 3}, {"pcg_iters": 4}]},
           "config": {"spec": {"backend": "sparse", "n_negatives": 5}},
           "traffic": {"spec": {"strategy": "sd"}}}
    _, nbytes = iteration.work(ctx)
    grad = ell.evaluation(10, 2, 30, 50, 5, True)[1]
    energy = ell.evaluation(10, 2, 30, 50, 5, False)[1]
    cg = ell.pcg_iteration(10, 2, 30, 50)[1]
    assert nbytes == (3 * grad + 2 * energy + 7 * cg) / 2
    ctx["fit"]["diagnostics"] = None
    assert iteration.work(ctx) is None


def test_bound_is_the_larger():
    assert peaks.bound_s(67e12, 0.0) == 1.0
    assert peaks.bound_s(0.0, 3.35e12) == 1.0
