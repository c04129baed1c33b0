"""The traced run's reduction on the CPU, where host operators stand in
for kernels: the per-layer metrics that the CPU can give are read, the
device's busy and traced seconds are there, and the breakdown keeps at
most ten entries of each kind."""
import pytest

from helpers import TINY, cpu_run


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run(cell):
    res = cpu_run(cell, trace=True)
    m = res["metrics"]
    pre = "sparse_" if cell.startswith("tenx1m3") else ""
    for name in ("affinities_s", "spectral_init_s", pre + "evals_per_iter",
                 pre + "idle_share", pre + "iter_mfu"):
        assert m[name]["value"] > 0, name
    assert 0 <= m[pre + "idle_share"]["value"] <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.01
    bd = res["breakdown"]
    assert 0 < len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert "iter_ms" not in m and "sparse_iter_ms" not in m
    if cell.startswith("tenx1m3"):
        assert m["pcg_iters"]["value"] > 0
