"""The reference agrees with the port at a tiny size on the CPU, where the
port runs its kernels' plain versions: a whole run of each cell comes out
`correct` against the cell's limits, and the pieces agree one by one."""
import math

import pytest
import torch

from helpers import TINY, cpu_run


@pytest.mark.parametrize("cell", sorted(TINY))
def test_whole_run_is_correct(cell):
    res = cpu_run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def _program():
    from harness.env import import_program
    return import_program()


def test_dense_affinities_match():
    _program()
    from repro_torch.core.affinities import make_affinities
    from reference import affinities_dense
    Y = torch.randn(300, 20, generator=torch.Generator().manual_seed(1))
    for kind in ("ee", "tsne"):
        got = make_affinities(Y, 15.0, model=kind).Wp.double()
        want = affinities_dense.attractive(Y, 15.0, kind)
        assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_dense_objective_matches():
    _program()
    from repro_torch.core.affinities import make_affinities
    from repro_torch.core.objectives import energy_and_grad
    from reference import objective_dense
    g = torch.Generator().manual_seed(2)
    Y, X = torch.randn(200, 10, generator=g), torch.randn(200, 2, generator=g)
    for kind, lam in (("ee", 100.0), ("tsne", 1.0), ("tee", 10.0)):
        aff = make_affinities(Y, 10.0, model=kind)
        E, G = energy_and_grad(X, aff, kind, lam)
        E_ref, G_ref = objective_dense.energy_and_grad(X, aff.Wp, kind, lam)
        assert abs(float(E) - E_ref) <= 1e-5 * abs(E_ref)
        assert float((G.double() - G_ref).abs().max()) <= 1e-4 * float(
            G_ref.abs().max())


def test_approximate_knn_matches_in_exact_arithmetic():
    """On data whose projections and distances float32 holds exactly
    (small integers), the frozen copy picks the program's neighbours."""
    _program()
    from repro_torch.sparse.graph import knn_graph_approx
    from reference import knn_approx
    g = torch.Generator().manual_seed(3)
    Y = torch.randint(-8, 8, (500, 6), generator=g).float()
    d2p, ip = knn_graph_approx(Y, 12, seed=5)
    d2r, ir = knn_approx.knn(Y, 12, 5)
    assert torch.allclose(d2p.double(), d2r)


@pytest.mark.parametrize("alpha,caught", [(1.0, False), (0.5, True),
                                          (0.25, True)])
def test_step_check_reads_a_changed_line_search(alpha, caught):
    """On E = |X|^2 / 2 with B = I / 0.9 the first trial step 1 passes: a
    program that backtracks once more, a factor rho, reads the Armijo slack
    at the step it skipped (most of E), and one that backtracks more reads
    the gap of the steps."""
    from reference import linesearch, steps
    X0 = torch.randn(50, 2, generator=torch.Generator().manual_seed(4),
                     dtype=torch.float64)

    def energy(X, k):
        return 0.5 * float(torch.sum(X * X))
    states, X = [], X0
    for _ in range(3):
        X = X - alpha * 0.9 * X
        states.append(X)
    Xs = [X0] + states
    fit = {"step_sizes": [alpha] * 3,
           "energies": [energy(x, 0) for x in Xs]}
    out = steps.check(X0, states, fit, energy,
                      lambda X, k: (energy(X, k), X.clone()),
                      lambda V: V / 0.9,
                      linesearch.dense_step, "one")
    assert out["dir_resid"] < 1e-12 and out["energy_gap"] < 1e-12
    assert (out["step_gap"] > 0.4) is caught
