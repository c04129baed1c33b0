"""The port's Barnes-Hut tree backend against the JAX reference.

The cell-interaction oracle and its dispatch, the grid plan and offsets, the
interaction batches, the repulsion, the energy and gradient and the whole
`tree` fit run on the CPU beside their `repro` counterparts on the same
numpy inputs.  Tolerances:

  * the cell interaction at rtol 5e-5 / atol 1e-5 (the reference's
    tests/test_farfield.py:192-195), the all-masked case exactly 0.  Against
    the reference's oracle, F's atol also has one float32 rounding of
    sum_j |w b| (|x_n| + |c_j|): that oracle forms F as (sum_j w b) x_n -
    sum_j w b c_j, which carries that rounding, and the port sums
    w b (x_n - c_j) as its kernel does;
  * the plan, the offsets and every batch's `idx` and `w` exactly: they are
    integers (cell ids, occupancies) computed from float32 cell coordinates
    in the reference's order;
  * the centre-of-mass tables to the rounding of their float32 cumulative
    sums (see `_table_atol`): the two libraries scan in different orders;
  * the repulsive sum, the energy and the gradient at rtol 1e-4, with an
    absolute floor of 1e-5 max|.| for the entries of F and G that cancel
    towards zero (a float32 sum is good to its terms' size, not to its own);
  * energy traces at rtol 1e-4 (tests/test_api.py:92) with equal PCG counts
    at mu_scale = 1e-3.  At the default mu_scale the SD system's near-null
    constant mode amplifies rounding (see tests/test_torch_sparse.py,
    MU_SCALE), so there the port is held within 3x of the reference's own
    jnp-vs-Pallas-interpret spread.

theta = 0 (the exhaustive batch) is held to JAX's tree output, not to the
dense O(N^2) oracle, which JAX itself misses by 1.5e-5 for the Student-t
kinds (ROADMAP.md, the reference caveat test_theta_zero_matches_dense).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Embedding as JEmbedding
from repro.api import EmbedSpec as JEmbedSpec
from repro.embed.trainer import _sparse_spectral_init as jspectral_init
from repro.kernels import ops as jops
from repro.kernels.ref import bh_interaction_ref as jbh_ref
from repro.sparse import farfield as jfar
from repro.sparse import sparse_affinities as jsparse_affinities
from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import (KINDS, bh_interaction_ref,
                                     negative_pair_terms)
from repro_torch.sparse import (GridPlan, energy_and_grad_tree,
                                make_grid_plan, tree_diagnostics,
                                tree_repulsion)
from repro_torch.sparse import farfield as pfar

MU_SCALE = 1e-3          # as tests/test_torch_sparse.py
EPS32 = float(np.finfo(np.float32).eps)


def _t(a, dtype=None):
    return torch.tensor(np.array(a), dtype=dtype)


def _cloud(n, seed=0, scale=1.0):
    """A 2-D cloud of four clusters (uneven cell occupancy, as the
    reference's `_cloud`), drawn with numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 2)) * 2.0
    X = centers[np.arange(n) % 4] + rng.normal(size=(n, 2)) * 0.4
    return (X * scale).astype(np.float32)


def _degenerate(seed=1):
    """N = 300 with many duplicated points: three points repeated 60 times
    each and a packed cluster of 120, so that cells spill past `cap` and
    the residual batch (self_spill included) carries weight."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(3, 2))
    X = np.concatenate([np.repeat(base, 60, axis=0),
                        rng.normal(size=(120, 2)) * 1e-3])
    return X.astype(np.float32)


def _bh_problem(n, width, m, d, seed):
    """Slots with zero weights, an all-zero row (3) and a row of one
    repeated index (5), as the kernel contract names them."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    table = (1.5 * rng.normal(size=(m, d))).astype(np.float32)
    idx = rng.integers(0, m, size=(n, width)).astype(np.int32)
    w = np.where(rng.uniform(size=(n, width)) < 0.3, 0.0,
                 1.0 + rng.integers(0, 16, size=(n, width))).astype(np.float32)
    w[3] = 0.0
    idx[5] = idx[5, 0]
    return X, idx, w, table


def _oracle_rounding(X, idx, w, table, kind):
    """One float32 rounding of sum_j |w b| (|x_n| + |c_j|), in float64: what
    the reference oracle's (sum_j w b) x_n - sum_j w b c_j may carry."""
    g = table[idx].astype(np.float64)
    X64 = X.astype(np.float64)
    t = np.sum((X64[:, None, :] - g) ** 2, axis=-1)
    _, b = negative_pair_terms(kind, torch.from_numpy(t))
    wb = np.abs(w * b.numpy())
    return EPS32 * np.einsum("nw,nwd->nd", wb,
                             np.abs(X64)[:, None, :] + np.abs(g))


# -- the cell-interaction contract ----------------------------------------------


@pytest.mark.parametrize("width", [1, 25, 96, 128])
@pytest.mark.parametrize("kind", KINDS)
def test_bh_interaction_ref_matches_jax(kind, width):
    for d in (1, 2, 3):
        X, idx, w, table = _bh_problem(70, width, 24, d, seed=width + d)
        js, jF = jbh_ref(jnp.asarray(X), jnp.asarray(idx), jnp.asarray(w),
                         jnp.asarray(table), kind)
        s, F = bh_interaction_ref(_t(X), _t(idx), _t(w), _t(table), kind)
        assert s.shape == (70,) and F.shape == (70, d)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=5e-5,
                                   atol=1e-5, err_msg=f"s d={d}")
        err = np.abs(F.numpy() - np.asarray(jF))
        tol = 1e-5 + 5e-5 * np.abs(np.asarray(jF)) + _oracle_rounding(
            X, idx, w, table, kind)
        assert np.all(err <= tol), (d, float((err - tol).max()))
        assert float(s[3]) == 0.0 and bool(torch.all(F[3] == 0))


def test_bh_interaction_zero_weight_masks_exactly():
    # w = 0 adds nothing even at t = 0 (slots pointing at the row itself)
    X = torch.ones((8, 2))
    idx = torch.zeros((8, 4), dtype=torch.int32)
    w = torch.zeros((8, 4))
    for kind in KINDS:
        s, F = ops.bh_interaction(X, idx, w, X, kind)
        assert float(s.abs().sum()) == 0.0 and float(F.abs().sum()) == 0.0
    assert ops.last_dispatch("bh_interaction") == {
        "path": "torch", "reason": "cpu-tensor", "storage": "float32"}


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_bh_interaction_dispatch_matches_jax_pallas_interpret(kind, storage):
    """The port's plain path against JAX's Pallas kernel in interpret mode,
    bf16 storage of X and the table included; w stays float32 on both sides.
    The shapes and weights are those of the reference's own test of that
    path (tests/test_farfield.py:180-195: N = 70, W = 12, M = 24, weights
    1..12): the Pallas kernel forms t by the Gram identity and F as
    (sum_j w b) x_n - sum_j w b c_j, which lose digits to cancellation as a
    row's weight grows."""
    rng = np.random.default_rng(8)
    n, width, m = 70, 12, 24
    X = rng.normal(size=(n, 2)).astype(np.float32)
    table = (1.5 * rng.normal(size=(m, 2))).astype(np.float32)
    idx = rng.integers(0, m, size=(n, width)).astype(np.int32)
    w = np.where(rng.uniform(size=(n, width)) < 0.3, 0.0,
                 1.0 + np.arange(width)).astype(np.float32)
    js, jF = jops.bh_interaction(jnp.asarray(X), jnp.asarray(idx),
                                 jnp.asarray(w), jnp.asarray(table), kind,
                                 impl="pallas-interpret",
                                 storage_dtype=storage, block_rows=8)
    s, F = ops.bh_interaction(_t(X), _t(idx), _t(w), _t(table), kind,
                              impl="torch", storage_dtype=storage)
    assert ops.last_dispatch("bh_interaction") == {
        "path": "torch", "reason": "forced-off", "storage": storage}
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=5e-5,
                               atol=1e-5)
    np.testing.assert_allclose(F.numpy(), np.asarray(jF), rtol=5e-5,
                               atol=1e-5)


def test_bh_interaction_rejects_what_it_cannot_take():
    X, idx, w, table = (_t(a) for a in _bh_problem(16, 8, 4, 2, seed=0))
    with pytest.raises(ValueError, match="kind"):
        ops.bh_interaction(X, idx, w, table, "nope")
    with pytest.raises(ValueError, match="impl"):
        ops.bh_interaction(X, idx, w, table, "ee", impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ops.bh_interaction(X, idx, w, table, "ee", impl="kernel")
    with pytest.raises(ValueError, match="storage_dtype"):
        ops.bh_interaction(X, idx, w, table, "ee", storage_dtype="float16")


# -- the plan and the offsets ---------------------------------------------------


@pytest.mark.parametrize("theta", [0.0, 0.25, 0.5, 1.0])
def test_grid_plan_and_offsets_match_jax(theta):
    for n in (2, 96, 600, 2000, 70000):
        got = make_grid_plan(n, theta=theta)
        assert isinstance(got, GridPlan)
        assert (dataclasses.asdict(got)
                == dataclasses.asdict(jfar.make_grid_plan(n, theta=theta)))
        assert got.exhaustive == (theta == 0.0)
    for r in (1, 2, 4):
        np.testing.assert_array_equal(pfar._far_offsets(r),
                                      jfar._far_offsets(r))
        np.testing.assert_array_equal(pfar._near_offsets(r),
                                      jfar._near_offsets(r))
    # the default plan at full MNIST: r = 2, l1 = 2, depth 8, cap 16
    full = make_grid_plan(70000)
    assert (full.r, full.l1, full.depth, full.cap) == (2, 2, 8, 16)
    assert pfar._far_offsets(2).shape == (96, 2)


def test_grid_plan_validation_matches_jax():
    for kw, match in [(dict(n=100, theta=1.5), "theta"),
                      (dict(n=100, theta=-0.1), "theta"),
                      (dict(n=1), "n="),
                      (dict(n=100, chunk=0), "chunk"),
                      (dict(n=100, theta=0.5, depth=1), "depth")]:
        kw = dict(kw)
        n = kw.pop("n")
        with pytest.raises(ValueError, match=match) as port:
            make_grid_plan(n, **kw)
        with pytest.raises(ValueError) as ref:
            jfar.make_grid_plan(n, **kw)
        assert str(port.value) == str(ref.value)


# -- the interaction batches ----------------------------------------------------


def _table_atol(X, plan):
    """The rounding of the centre-of-mass tables: each cell sum is a
    difference of two float32 cumulative sums over the points in sorted
    order, each off by a few ulps of the largest running sum in either
    library (their scans add in different orders), then divided by a count
    >= 1.  16 ulps of the largest |running sum|, computed in float64."""
    coords, _ = jfar._grid_coords(jnp.asarray(X), plan.depth)
    coords = np.asarray(coords)
    cid = coords[:, 0] * (1 << plan.depth) + coords[:, 1]
    csum = np.cumsum(X[np.argsort(cid, kind="stable")].astype(np.float64),
                     axis=0)
    return 16 * EPS32 * float(np.abs(csum).max())


@pytest.mark.parametrize("case", ["normal", "degenerate"])
def test_interaction_batches_match_jax(case):
    X = _cloud(600, seed=2) if case == "normal" else _degenerate()
    n = X.shape[0]
    plan = make_grid_plan(n)
    jb = jfar._interaction_batches(jnp.asarray(X), jfar.make_grid_plan(n))
    pb = pfar._interaction_batches(_t(X), plan)
    assert [b.tag for b in pb] == [b.tag for b in jb]
    assert [b.tag for b in pb] == ["far-l2", "far-l3", "far-l4", "near",
                                   "residual"]
    atol = _table_atol(X, plan)
    for got, want in zip(pb, jb):
        assert got.idx.dtype == torch.int32 and got.w.dtype == torch.float32
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx),
                                      err_msg=got.tag)
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w),
                                      err_msg=got.tag)
        np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table),
                                   rtol=0, atol=atol, err_msg=got.tag)
        np.testing.assert_allclose(float(got.h_cell), float(want.h_cell),
                                   rtol=0)
    diag = tree_diagnostics(_t(X), plan)
    assert float(diag["tree_pairs"]) == n * (n - 1)
    assert float(diag["tree_theta_ratio"]) <= plan.theta + 1e-6
    jdiag = jfar.tree_diagnostics(jnp.asarray(X), jfar.make_grid_plan(n))
    for k in ("tree_pairs", "tree_overflow"):
        assert float(diag[k]) == float(jdiag[k]), k
    for k in ("tree_cells", "tree_theta_ratio"):
        np.testing.assert_allclose(float(diag[k]), float(jdiag[k]),
                                   rtol=1e-6)
    if case == "degenerate":
        assert float(diag["tree_overflow"]) > 0


def test_self_spill_drops_the_point_itself():
    """In a cell of `count` > cap points, the count - cap points ranked past
    `cap` meet their own cell's residual centre of mass with weight
    count - cap - 1 (self dropped), the cap listed ones with count - cap."""
    X = _degenerate()
    plan = make_grid_plan(X.shape[0])
    res = pfar._interaction_batches(_t(X), plan)[-1]
    own = int(np.flatnonzero((pfar._near_offsets(plan.r) == 0).all(1))[0])
    w_own = res.w[:, own].numpy()
    coords, _ = pfar._grid_coords(_t(X), plan.depth)
    cid = (coords[:, 0] * (1 << plan.depth) + coords[:, 1]).numpy()
    spilled = 0
    for c in np.unique(cid):
        members = cid == c
        count = int(members.sum())
        if count <= plan.cap:
            assert np.all(w_own[members] == 0)
            continue
        spilled += 1
        vals, freq = np.unique(w_own[members], return_counts=True)
        assert vals.tolist() == [count - plan.cap - 1, count - plan.cap]
        assert freq.tolist() == [count - plan.cap, plan.cap]
    assert spilled >= 3


# -- the grid state and its expansion ------------------------------------------


def _lattice(depth):
    """(2^depth + 1)^2 points on the lines of a 2^depth grid over [0, 19]^2,
    in float32: each coordinate k 19 / 2^depth lies within rounding of a
    cell boundary (the box is widened by 1e-6), so float32 decides its
    cell."""
    G = 1 << depth
    k = np.arange(G + 1, dtype=np.float32) * np.float32(19.0 / G)
    return np.stack(np.meshgrid(k, k, indexing="ij"), -1).reshape(-1, 2)


def _state_case(case, theta):
    """(X, plan kwargs): a clustered cloud at the default cap, the same with
    cap = 2 (most cells spill into the residual), and the lattice."""
    if case == "lattice":
        n = 289                       # the default plan: depth 4 at theta
        depth = make_grid_plan(n, theta=theta).depth
        X = _lattice(depth)
        assert X.shape[0] == (2 ** depth + 1) ** 2
        return X, {"theta": theta}
    X = _cloud(600, seed=5)
    return X, {"theta": theta, **({"cap": 2} if case == "small-cap" else {})}


STATE_CASES = [(theta, case) for theta in (0.5, 1.0, 0.34)
               for case in ("cloud", "small-cap", "lattice")]


@pytest.mark.parametrize("theta,case", STATE_CASES)
def test_grid_state_expansion_matches_jax(theta, case):
    """`_interaction_batches` = the expansion of `_grid_state`: every batch's
    idx and w equal the reference's exactly (tables to the cumsum rounding),
    over opening angles, residual spill and points on cell boundaries; the
    state itself holds no (N, W) tensor."""
    X, kw = _state_case(case, theta)
    n = X.shape[0]
    plan = make_grid_plan(n, **kw)
    grid = pfar._grid_state(_t(X), plan)
    for f in dataclasses.fields(grid):
        for t in (getattr(grid, f.name) if f.name.startswith("level_")
                  else [getattr(grid, f.name)]):
            if isinstance(t, torch.Tensor):
                assert t.dim() <= 1 or t.shape[1] == 2, (f.name, t.shape)
    assert grid.n_batches == plan.depth - plan.l1 + 3
    jb = jfar._interaction_batches(jnp.asarray(X), jfar.make_grid_plan(n, **kw))
    pb = pfar._interaction_batches(_t(X), plan)
    assert [b.tag for b in pb] == [b.tag for b in jb]
    atol = _table_atol(X, plan)
    for got, want in zip(pb, jb):
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx),
                                      err_msg=got.tag)
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w),
                                      err_msg=got.tag)
        np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table),
                                   rtol=0, atol=atol, err_msg=got.tag)
        np.testing.assert_allclose(float(got.h_cell), float(want.h_cell),
                                   rtol=0)
    assert float(tree_diagnostics(_t(X), plan)["tree_pairs"]) == n * (n - 1)
    if case == "small-cap":
        assert float(pb[-1].w.sum()) > 0


@pytest.mark.parametrize("theta,case", STATE_CASES)
def test_tree_slots_are_the_batches_in_sorted_order(theta, case):
    """The fused kernel's slot arithmetic, written out in torch per sorted
    position p (`ref.tree_slots`: the far test from the cell id's shifted
    coords, the near self mask pos == p, the residual self-spill from
    p - starts[cid]), equals the reference's batches row for row: far and
    residual idx and w at row perm[p], near w likewise and near idx through
    perm."""
    X, kw = _state_case(case, theta)
    n = X.shape[0]
    plan = make_grid_plan(n, **kw)
    grid = pfar._grid_state(_t(X), plan)
    perm = grid.perm.numpy()
    assert np.all(np.diff(grid.cids.numpy()) >= 0)
    jb = jfar._interaction_batches(jnp.asarray(X), jfar.make_grid_plan(n, **kw))
    slots = ref.tree_slots(grid)
    assert len(slots) == grid.n_batches == len(jb)
    for (tag, idx, w, table), want in zip(slots, jb):
        assert tag == want.tag
        got_idx = perm[idx.numpy()] if tag == "near" else idx.numpy()
        np.testing.assert_array_equal(got_idx, np.asarray(want.idx)[perm],
                                      err_msg=tag)
        np.testing.assert_array_equal(w.numpy(), np.asarray(want.w)[perm],
                                      err_msg=tag)
        if tag == "near":
            assert table is grid.Xs
            # no listed slot of a row is its own sorted position
            rows = np.arange(n)[:, None]
            assert not np.any((idx.numpy() == rows) & (w.numpy() > 0))


def _spilling_cloud(n, seed):
    """`_cloud(n)` and three points repeated 40 times each: at the default
    cap (16) their cells spill 24 points into the residual, self included."""
    rng = np.random.default_rng(seed)
    dup = np.repeat(rng.normal(size=(3, 2)).astype(np.float32), 40, axis=0)
    return np.concatenate([_cloud(n, seed=seed), dup])


@pytest.mark.parametrize("theta,depth", [(0.5, 7), (0.5, 8), (0.34, 8)])
def test_batches_and_slots_match_jax_at_depth(theta, depth):
    """At the main path's depth (N = 70000 plans depth 8; 7 and 8 here, at
    the default cap, with cells that spill), both derivations of the slots
    equal the reference's batches exactly: `_interaction_batches` (whole
    (N, W) gathers, rows in X's order) and `ref.tree_slots` (the fused
    kernel's per-sorted-position arithmetic, rows at perm[p], near idx
    through perm)."""
    X = _spilling_cloud(3000, seed=8)
    n = X.shape[0]
    kw = {"theta": theta, "depth": depth}
    plan = make_grid_plan(n, **kw)
    assert plan.depth == depth and plan.cap == 16
    jb = jfar._interaction_batches(jnp.asarray(X), jfar.make_grid_plan(n, **kw))
    pb = pfar._interaction_batches(_t(X), plan)
    grid = pfar._grid_state(_t(X), plan)
    perm = grid.perm.numpy()
    slots = ref.tree_slots(grid)
    assert [b.tag for b in pb] == [b.tag for b in jb] == [t[0] for t in slots]
    assert float(np.asarray(jb[-1].w).sum()) >= 3 * 24
    for got, (tag, idx, w, _), want in zip(pb, slots, jb):
        want_idx, want_w = np.asarray(want.idx), np.asarray(want.w)
        np.testing.assert_array_equal(got.idx.numpy(), want_idx, err_msg=tag)
        np.testing.assert_array_equal(got.w.numpy(), want_w, err_msg=tag)
        slot_idx = perm[idx.numpy()] if tag == "near" else idx.numpy()
        np.testing.assert_array_equal(slot_idx, want_idx[perm], err_msg=tag)
        np.testing.assert_array_equal(w.numpy(), want_w[perm], err_msg=tag)
    assert float(sum(b.w.double().sum() for b in pb)) == n * (n - 1)


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [0.5, 1.0, 0.34])
@pytest.mark.parametrize("kind", KINDS)
def test_bh_tree_plain_matches_batched_path(kind, theta, storage):
    """`ops.bh_tree` on CPU tensors (its plain version, `ref.bh_tree_ref`)
    gives each batch's s row and the summed F of the per-batch path
    (`_apply_chunked` over the materialised batches, the same slices in the
    same order), at rtol 1e-6: the same float32 terms, summed alike.
    `tree_repulsion` on CPU takes it: its F and s are those of the call."""
    X = _t(_cloud(600, seed=6))
    plan = make_grid_plan(600, theta=theta, cap=3)
    s_rows, F = ops.bh_tree(pfar._grid_state(X, plan), kind,
                            storage_dtype=storage)
    assert ops.last_dispatch("bh_tree") == {
        "path": "torch", "reason": "cpu-tensor", "storage": storage}
    batches = pfar._interaction_batches(X, plan)
    assert s_rows.shape == (len(batches), 600) and F.shape == (600, 2)
    F_want = torch.zeros_like(F)
    for row, b in zip(s_rows, batches):
        s_b, F_b = pfar._apply_chunked(X, b, kind, plan.chunk,
                                       {"storage_dtype": storage})
        _close(row.numpy(), s_b.numpy(), rtol=1e-6, floor=1e-7)
        F_want = F_want + F_b
    _close(F.numpy(), F_want.numpy(), rtol=1e-6, floor=1e-7)
    s, F_tree = tree_repulsion(X, plan, kind, storage_dtype=storage)
    assert ops.last_dispatch("bh_tree")["path"] == "torch"
    assert torch.equal(F_tree, F)
    s_want = torch.zeros((), dtype=torch.float32)
    for row in s_rows:
        s_want = s_want + torch.sum(row)
    assert torch.equal(s, s_want)


def test_bh_tree_rejects_what_it_cannot_take():
    X = _t(_cloud(64, seed=7))
    grid = pfar._grid_state(X, make_grid_plan(64))
    with pytest.raises(ValueError, match="kind"):
        ops.bh_tree(grid, "nope")
    with pytest.raises(ValueError, match="CUDA"):
        ops.bh_tree(grid, "ee", impl="kernel")
    with pytest.raises(ValueError, match="storage_dtype"):
        ops.bh_tree(grid, "ee", storage_dtype="float16")
    with pytest.raises(ValueError, match="exhaustive"):
        pfar._grid_state(X, make_grid_plan(64, theta=0.0))


def test_tree_repulsion_rejects_non_2d():
    with pytest.raises(ValueError, match="2-D"):
        tree_repulsion(torch.zeros((32, 3)), make_grid_plan(32), "tsne")


# -- repulsion, energy and gradient ---------------------------------------------


def _close(got, want, rtol=1e-4, floor=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()))


@pytest.mark.parametrize("theta,n", [(0.5, 600), (0.0, 96)])
@pytest.mark.parametrize("kind", KINDS)
def test_tree_repulsion_matches_jax(kind, theta, n):
    X = _cloud(n, seed=1 if theta == 0 else 2)
    js, jF = jfar.tree_repulsion(jnp.asarray(X),
                                 jfar.make_grid_plan(n, theta=theta), kind)
    plan = make_grid_plan(n, theta=theta)
    s, F = tree_repulsion(_t(X), plan, kind)
    assert s.shape == () and F.shape == (n, 2)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-4)
    _close(F.numpy(), jF)
    s2, F2 = tree_repulsion(_t(X), plan, kind)
    assert float(s2) == float(s) and torch.equal(F2, F)


def _saff_problem(n, kind, seed=3):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(n, 8)).astype(np.float32)
    js = jsparse_affinities(jnp.asarray(Y), k=8, perplexity=3.0, model=kind)
    ps = convert.saff_from_numpy(js.graph.indices, js.graph.weights,
                                 js.rev.indices, js.rev.weights, "cpu")
    return js, ps


@pytest.mark.parametrize("theta,n", [(0.5, 600), (0.0, 96)])
@pytest.mark.parametrize("kind", KINDS)
def test_energy_and_grad_tree_matches_jax(kind, theta, n):
    js, ps = _saff_problem(n, kind)
    X = _cloud(n, seed=4, scale=0.5)
    lam = 2.0
    jplan = jfar.make_grid_plan(n, theta=theta)
    jE, jG = jfar.energy_and_grad_tree(jnp.asarray(X), js, jnp.float32(lam),
                                       kind, jplan)
    plan = make_grid_plan(n, theta=theta)
    E, G = energy_and_grad_tree(_t(X), ps, torch.tensor(lam), kind, plan)
    np.testing.assert_allclose(float(E), float(jE), rtol=1e-4)
    _close(G.numpy(), jG)
    E_only, none = energy_and_grad_tree(_t(X), ps, torch.tensor(lam), kind,
                                        plan, with_grad=False)
    assert none is None and float(E_only) == float(E)
    E2, G2 = energy_and_grad_tree(_t(X), ps, torch.tensor(lam), kind, plan)
    assert float(E2) == float(E) and torch.equal(G2, G)


# -- the whole tree fit ---------------------------------------------------------


def _tree_problem():
    """The reference's `tree_problem` (tests/test_farfield.py:212-218):
    N = 220, perplexity 5, k = 12, 15 iterations; Y drawn with numpy."""
    rng = np.random.default_rng(9)
    return rng.normal(size=(220, 10)).astype(np.float32)


def _fit_pair(kind, lam, *, mu_scale=MU_SCALE, jax_impl="jnp", iters=15):
    """The JAX tree fit and the port's from JAX's affinities and start."""
    Y = _tree_problem()
    jspec = JEmbedSpec(kind=kind, strategy="sd", backend="tree", lam=lam,
                       perplexity=5.0, n_neighbors=12, max_iters=iters,
                       tol=0.0, mu_scale=mu_scale, kernel_impl=jax_impl)
    js = jsparse_affinities(jnp.asarray(Y), k=12, perplexity=5.0, model=kind)
    X0 = jspectral_init(jspec, js, Y.shape[0])
    jd, pd = [], []
    jres = JEmbedding(jspec).fit(None, X0=X0, saff=js,
                                 callback=lambda it, X, e, d: jd.append(d)
                                 ).result_
    spec = convert.spec_from_jax_fields(dataclasses.asdict(jspec))
    ps = convert.saff_from_numpy(js.graph.indices, js.graph.weights,
                                 js.rev.indices, js.rev.weights, "cpu")
    emb = Embedding(spec, device="cpu").fit(
        None, X0=convert.embedding_from_numpy(X0, "cpu"), saff=ps,
        callback=lambda it, X, e, d: pd.append(d))
    return jres, jd, emb, pd


@pytest.mark.parametrize("kind,lam", [("tsne", 1.0), ("ee", 10.0)])
def test_tree_fit_trace_matches_jax(kind, lam):
    jres, jd, emb, pd = _fit_pair(kind, lam)
    res = emb.result_
    assert emb.backend_ == "tree" and res.n_iters == jres.n_iters == 15
    np.testing.assert_allclose(res.energies, jres.energies, rtol=1e-4)
    assert [d["pcg_iters"] for d in pd] == [d["pcg_iters"] for d in jd]
    np.testing.assert_array_equal(res.n_fevals, jres.n_fevals)
    np.testing.assert_allclose(res.step_sizes, jres.step_sizes, rtol=1e-4)
    # deterministic objective + Armijo line search: monotone
    e = res.energies
    assert e[-1] < e[0] and np.all(np.diff(e) <= 1e-5 * np.abs(e[:-1]))
    n = 220
    assert all(d["tree_pairs"] == n * (n - 1) for d in pd)
    assert all(d["tree_theta_ratio"] <= 0.5 + 1e-6 for d in pd)
    for key in ("tree_pairs", "tree_overflow"):
        assert [d[key] for d in pd] == [d[key] for d in jd]
    np.testing.assert_allclose([d["tree_cells"] for d in pd],
                               [d["tree_cells"] for d in jd], rtol=1e-4)


@pytest.mark.parametrize("kind,lam", [("tsne", 1.0), ("ee", 10.0)])
def test_tree_fit_trace_at_default_mu_scale(kind, lam):
    """At the default mu_scale = 1e-5 (see MU_SCALE) the port's trace stays
    within rtol 1e-4 of the reference's jnp path, and within 3x of the
    reference's own spread: how far its Pallas-interpret path (the same
    float32 sums in another order) parts from its jnp path.  PCG counts are
    not compared."""
    jres, _, emb, _ = _fit_pair(kind, lam, mu_scale=1e-5)
    ires, _, _, _ = _fit_pair(kind, lam, mu_scale=1e-5,
                              jax_impl="pallas-interpret")
    want = np.asarray(jres.energies)
    got = emb.result_.energies
    assert emb.result_.n_iters == jres.n_iters == ires.n_iters == 15
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    port = float(np.max(np.abs(got - want) / np.abs(want)))
    spread = float(np.max(np.abs(np.asarray(ires.energies) - want)
                          / np.abs(want)))
    print(f"{kind} mu_scale=1e-5: port vs jnp {port:.2e}, "
          f"Pallas-interpret vs jnp {spread:.2e}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert port <= 3.0 * spread, (port, spread)
    assert got[-1] < got[0]


def test_tree_fit_is_deterministic_and_takes_saff():
    """No random draw anywhere: two fits are bit-identical, with the graph
    built inside or passed as saff= (the reference's
    test_fit_saff_on_tree_backend)."""
    Y = _tree_problem()
    spec = EmbedSpec(kind="tsne", strategy="sd", backend="tree", lam=1.0,
                     perplexity=5.0, n_neighbors=12, max_iters=6, tol=0.0)
    a = Embedding(spec, device="cpu").fit(Y)
    b = Embedding(spec, device="cpu").fit(Y, saff=a.affinities_)
    assert a.backend_ == b.backend_ == "tree"
    assert torch.equal(a.embedding_, b.embedding_)
    assert np.array_equal(a.result_.energies, b.result_.energies)
    assert set(a.result_.phase_times) == {
        "knn_s", "calibrate_s", "reverse_s", "spectral_init_s"}
    # under backend="auto" a saff= pins the sparse backend instead
    auto = Embedding(spec.replace(backend="auto", max_iters=2),
                     device="cpu").fit(Y, saff=a.affinities_)
    assert auto.backend_ == "sparse"
    assert "fitted[tree]" in repr(a)


def test_tree_backend_rejects_what_it_cannot_take():
    Y = _tree_problem()[:64, :6]
    spec = EmbedSpec(kind="tsne", backend="tree", perplexity=3.0,
                     max_iters=3)
    with pytest.raises(ValueError, match="2-D only"):
        Embedding(spec.replace(dim=3), device="cpu").fit(Y)
    with pytest.raises(ValueError, match="dense-backend-only"):
        Embedding(spec, device="cpu").fit(Y, aff=object())
    with pytest.raises(ValueError, match="samples nothing"):
        Embedding(spec, device="cpu").fit(Y, shift_source=lambda s, i: None)
    with pytest.raises(ValueError, match="rows"):
        a = Embedding(spec.replace(max_iters=1), device="cpu").fit(Y)
        Embedding(spec, device="cpu").fit(Y[:30], saff=a.affinities_)


def test_spec_tree_knobs_validate_and_convert_carries_them():
    with pytest.raises(ValueError, match="theta"):
        EmbedSpec(theta=2.0)
    with pytest.raises(ValueError, match="tree_depth"):
        EmbedSpec(tree_depth=-1)
    with pytest.raises(ValueError, match="tree_cap"):
        EmbedSpec(tree_cap=-3)
    with pytest.raises(ValueError, match="tree_cap"):
        EmbedSpec(tree_cap=1.5)
    assert (EmbedSpec().theta, EmbedSpec().tree_depth,
            EmbedSpec().tree_cap) == (0.5, 0, 0)
    fields = dataclasses.asdict(JEmbedSpec(kind="tsne", backend="tree",
                                           theta=0.25, tree_depth=5,
                                           tree_cap=24))
    spec = convert.spec_from_jax_fields(fields)
    assert (spec.backend, spec.theta, spec.tree_depth, spec.tree_cap) == (
        "tree", 0.25, 5, 24)
    assert not {"theta", "tree_depth", "tree_cap"} & convert.UNPORTED_FIELDS
    for strategy in ("sd", "fp", "gd"):
        EmbedSpec(strategy=strategy, backend="tree")


@pytest.mark.parametrize("strategy", ["fp", "gd"])
def test_tree_diagonal_strategies_match_jax(strategy):
    Y = _tree_problem()
    jspec = JEmbedSpec(kind="ee", strategy=strategy, backend="tree",
                       lam=10.0, perplexity=5.0, n_neighbors=12, max_iters=6,
                       tol=0.0, kernel_impl="jnp")
    js = jsparse_affinities(jnp.asarray(Y), k=12, perplexity=5.0, model="ee")
    X0 = jspectral_init(jspec, js, Y.shape[0])
    jres = JEmbedding(jspec).fit(None, X0=X0, saff=js).result_
    ps = convert.saff_from_numpy(js.graph.indices, js.graph.weights,
                                 js.rev.indices, js.rev.weights, "cpu")
    emb = Embedding(convert.spec_from_jax_fields(dataclasses.asdict(jspec)),
                    device="cpu").fit(
        None, X0=convert.embedding_from_numpy(X0, "cpu"), saff=ps)
    e = emb.result_.energies
    assert e[-1] < e[0]
    np.testing.assert_allclose(e, jres.energies, rtol=1e-4)
