"""Rank side of tests/test_torch_sharding.py and
tests/test_torch_distributed_embed.py: the port's mesh backends (the
row-sharded sparse one and the 2-D-sharded dense one) and its meshes run
inside a gloo process group on the CPU.  It holds no tests itself.

Spawned by `spawn_ranks`, one process per rank; it imports only torch and
repro_torch (JAX's side is computed in the test process and handed over as
numpy).  Each rank runs the jobs it is given and writes its results, as
numpy, to `<out_dir>/rank<r>.pt`.
"""
from __future__ import annotations

import datetime
import itertools
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.api import Embedding, EmbedSpec
from repro_torch.embed.distributed import (EmbedMeshSpec,
                                           make_block_jacobi_setup,
                                           make_block_jacobi_solve,
                                           make_distributed_energy_grad,
                                           replicate, shard_pairwise,
                                           shard_rows)
from repro_torch.embed.engine import LoopConfig, fit_loop, make_loop_config
from repro_torch.embed.trainer import build_sparse_objective
from repro_torch.launch import Mesh, linear_row_index, make_host_mesh
from repro_torch.sparse import (NeighborGraph, SparseAffinities,
                                make_sd_operator, make_sharded_energy_grad,
                                make_sharded_sd_operator,
                                shard_sparse_affinities)
from repro_torch.sparse.sharding import assert_replicated

#: seconds a collective may wait for the other ranks before it fails
GROUP_TIMEOUT_S = 60
#: seconds a whole spawn may take before its ranks are killed
SPAWN_TIMEOUT_S = 300


def spawn_ranks(world: int, jobs: list, tmp: Path) -> list[dict]:
    """Run `jobs` on `world` spawned gloo ranks (a file:// store under
    `tmp`, so that concurrent test workers never share a port); returns
    each rank's results.  Raises if a rank fails or the spawn outlives
    SPAWN_TIMEOUT_S (a deadlock), after killing its processes."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(_rank_main, args=(world, str(tmp / "store"), jobs,
                                     str(tmp)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{SPAWN_TIMEOUT_S} s (a deadlock?)")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, store: str, jobs: list,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = {name: JOBS[kind](**kw) for name, kind, kw in jobs}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _t(a, dtype=torch.float32):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype)


def _saff(arrays):
    return convert.saff_from_numpy(*arrays, "cpu")


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def job_energy_grad(kind, lam, m, arrays, X, shifts, shifts2):
    """Sharded E, G (and z) at X; e_only's E; for normalized kinds a second
    application from the first's z (warm EMA) with `shifts2`."""
    mesh = make_host_mesh()
    sg = shard_sparse_affinities(mesh, ("data",), _saff(arrays))
    eg, e_only = make_sharded_energy_grad(mesh, ("data",), sg, kind,
                                          n_negatives=m)
    X, lam = _t(X), torch.tensor(lam)
    sh = _t(shifts, torch.int32)
    out = {"row0": sg.row0, "nb": sg.indices.shape[0], "n_pad": sg.n_pad,
           "E_only": float(e_only(X, lam, sh))}
    if kind in ("ssne", "tsne"):
        E, G, z = eg(X, lam, sh, torch.zeros(()))
        E2, G2, z2 = eg(X, lam, _t(shifts2, torch.int32), z)
        out.update(z=float(z), G2=_np(G2), z2=float(z2))
    else:
        E, G = eg(X, lam, sh)
    out.update(E=float(E), G=_np(G))
    return out


def job_operator(arrays, V, mu_scale):
    """The sharded SD operator's matvec, Jacobi diagonal and mu, and the
    single-device operator's diagonal and mu beside them."""
    mesh = make_host_mesh()
    saff = _saff(arrays)
    sg = shard_sparse_affinities(mesh, ("data",), saff)
    mv, inv_diag, mu = make_sharded_sd_operator(mesh, ("data",), sg, saff,
                                                mu_scale)
    _, inv_diag1, mu1 = make_sd_operator(saff.graph, saff.rev, mu_scale)
    return {"mv": _np(mv(_t(V))), "inv_diag": _np(inv_diag),
            "mu": float(mu), "single_inv_diag": _np(inv_diag1),
            "single_mu": float(mu1)}


def _shift_table(table, seed):
    def source(s, it):
        assert s == seed, (s, seed)
        return torch.tensor(table[it], dtype=torch.int32)
    return source


def _result(res, diags):
    return {"energies": res.energies, "step_sizes": res.step_sizes,
            "grad_norms": res.grad_norms, "n_fevals": res.n_fevals,
            "n_iters": res.n_iters, "X": _np(res.X),
            "pcg_iters": [d.get("pcg_iters") for d in diags],
            "z_ema": [d.get("z_ema") for d in diags]}


def job_fit(spec_fields, arrays, X0, shift_table):
    """The trainer-level sharded fit with the reference's graph, start and
    per-iteration draws carried in."""
    spec = convert.spec_from_jax_fields(spec_fields)
    diags = []
    obj, X0t, _ = build_sparse_objective(
        spec, None, _t(X0), strategy=spec.strategy, sharded=True,
        saff=_saff(arrays), device="cpu", mesh=make_host_mesh(),
        shift_source=_shift_table(shift_table, spec.seed + 1))
    res = fit_loop(obj, X0t, make_loop_config(spec, spec.resolved_ls()),
                   lambda it, X, e, d: diags.append(d))
    return _result(res, diags)


def job_budget(spec_fields, arrays, X0, max_seconds, sleep_s):
    """A fit under a time budget in which rank 1's clock runs ahead: it
    sleeps `sleep_s` in every callback."""
    spec = convert.spec_from_jax_fields(spec_fields)
    mesh = make_host_mesh()
    obj, X0t, _ = build_sparse_objective(
        spec, None, _t(X0), strategy=spec.strategy, sharded=True,
        saff=_saff(arrays), device="cpu", mesh=mesh)
    slow = mesh.rank == 1

    def callback(it, X, e, d):
        if slow:
            time.sleep(sleep_s)

    res = fit_loop(obj, X0t, LoopConfig(max_iters=spec.max_iters, tol=0.0,
                                        ls=spec.resolved_ls(),
                                        seed=spec.seed,
                                        max_seconds=max_seconds), callback)
    return {"n_iters": res.n_iters, "energies": res.energies,
            "X": _np(res.X)}


def _raised(fn, exc=ValueError) -> str | None:
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def job_api(spec_fields, Y):
    """`Embedding(backend="sparse-sharded")` against the trainer-level run
    of the same spec; `auto`'s pick in this group; the estimator's refusals
    and the mesh's arithmetic."""
    spec = EmbedSpec(**spec_fields)
    Yt = _t(Y)
    emb = Embedding(spec, device="cpu", mesh=make_host_mesh()).fit(Y)
    obj, X0, _ = build_sparse_objective(spec, Yt, strategy=spec.strategy,
                                        sharded=True, device="cpu",
                                        mesh=make_host_mesh())
    trainer = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()))
    world = dist.get_world_size()
    wide = Mesh({"data": 1, "model": world})
    auto = Embedding(EmbedSpec(), device="cpu")
    g = emb.affinities_.graph
    bad = g.indices.clone()
    bad[3, 1] = g.n
    bad_saff = SparseAffinities(NeighborGraph(bad, g.weights),
                                emb.affinities_.rev)
    return {
        "api": {"energies": emb.result_.energies, "X": _np(emb.embedding_),
                "backend": emb.backend_, "X0": _np(emb.X0_)},
        "trainer": {"energies": trainer.energies, "X": _np(trainer.X),
                    "X0": _np(X0)},
        "auto": {n: auto._resolve_backend(n) for n in (2048, 2049)},
        "errors": {
            "non_row_axis": _raised(lambda: Embedding(
                spec, device="cpu", mesh=wide).fit(Y)),
            "row_axis_missing": _raised(lambda: build_sparse_objective(
                spec, Yt, sharded=True, device="cpu", mesh=make_host_mesh(),
                mspec=EmbedMeshSpec(row_axes=("rows",)))),
            "aff": _raised(lambda: Embedding(spec, device="cpu").fit(
                Y, aff=object())),
            "saff": _raised(lambda: Embedding(spec, device="cpu").fit(
                None, saff=emb.affinities_)),
            "mesh_size": _raised(lambda: Mesh({"data": world + 1})),
            "index_range": _raised(lambda: shard_sparse_affinities(
                make_host_mesh(), ("data",), bad_saff)),
            "replicated_same": _raised(lambda: assert_replicated(
                make_host_mesh(), Yt, torch.arange(5.0)), RuntimeError),
            "replicated_differ": _raised(lambda: assert_replicated(
                make_host_mesh(), Yt, torch.full((5,), float(dist.get_rank(
                )))), RuntimeError),
        },
        "linear_row_index": [linear_row_index(Mesh(shape), ("data",))
                             for shape in ({"data": world, "model": 1},
                                           {"model": 1, "data": world})],
    }


def job_resume(spec_fields, Y, ckdir, stop):
    """A sparse-sharded fit run straight through `spec.max_iters`
    iterations, and the same fit stopped at `stop` and resumed from the
    checkpoint that rank 0 wrote in `ckdir` (every rank passes the same
    directory)."""
    spec = EmbedSpec(**spec_fields)

    def est(s):
        return Embedding(s, device="cpu", mesh=make_host_mesh())

    full = est(spec).fit(Y)
    part = spec.replace(max_iters=stop, checkpoint_dir=ckdir)
    est(part).fit(Y)
    res = est(part).resume(Y, max_iters=spec.max_iters)
    return {"full": {"energies": full.result_.energies,
                     "X": _np(full.embedding_)},
            "resumed": {"energies": res.result_.energies,
                        "X": _np(res.embedding_),
                        "resumed_from": res.result_.resumed_from,
                        "n_iters": res.result_.n_iters}}


def job_mesh_groups(shapes):
    """For each mesh shape: this rank's coordinates and, for every subset
    of the axes, `axis_group`'s members and the sum of 2**rank over its
    process group (the members that really took part); then
    `make_host_mesh(model_axis=2)`'s shape and the refusal of a model axis
    that does not divide the group."""
    meshes = []
    for shape in shapes:
        mesh = Mesh(shape)
        groups = {}
        for k in range(len(shape) + 1):
            for axes in itertools.combinations(mesh.axis_names, k):
                ag = mesh.axis_group(axes)
                t = torch.tensor([2.0 ** mesh.rank])
                if ag.size > 1:
                    dist.all_reduce(t, group=ag.group)
                groups[axes] = (ag.ranks, int(t))
        meshes.append({"coords": mesh.coords, "groups": groups})
    return {"meshes": meshes,
            "host2": dict(make_host_mesh(model_axis=2).shape),
            "bad_model_axis": _raised(lambda: make_host_mesh(model_axis=3))}


def _mesh_and_spec(shape, row_axes, col_axis):
    return Mesh(shape), EmbedMeshSpec(tuple(row_axes), col_axis)


def job_dense_eg(shape, row_axes, col_axis, X, cases):
    """The 2-D-sharded E and G of every case ({name: (kind, lam, Wp, Wm or
    None for unit W-)}) at X: this rank's row block, the replicated G,
    e_only's E, this rank's row block index and tile shape."""
    mesh, spec = _mesh_and_spec(shape, row_axes, col_axis)
    X = _t(X)
    out = {"row_block": linear_row_index(mesh, spec.row_axes),
           "rows": _np(shard_rows(mesh, spec, X))}
    for name, (kind, lam, Wp, Wm) in cases.items():
        unit = Wm is None
        eg = make_distributed_energy_grad(mesh, spec, kind, unit_wm=unit)
        ws = [shard_pairwise(mesh, spec, _t(W)) for W in (Wp, Wm)
              if W is not None]
        lam = torch.tensor(lam)
        E, G = eg(X, *ws, lam)
        out[name] = {"E": float(E), "G_rows": _np(G),
                     "G": _np(replicate(mesh, G, spec)),
                     "E_only": float(eg(X, *ws, lam, with_grad=False)),
                     "tile": tuple(ws[0].shape)}
    return out


def job_block_jacobi(shape, Wp, G, mu_scale):
    """This rank's block-Jacobi factor of W+ and the direction -B^-1 G on
    its rows, and that direction replicated."""
    mesh, spec = _mesh_and_spec(shape, ("data",), "model")
    R = make_block_jacobi_setup(mesh, spec, mu_scale)(
        shard_pairwise(mesh, spec, _t(Wp)))
    P = make_block_jacobi_solve(mesh, spec)(R, shard_rows(mesh, spec,
                                                          _t(G)))
    return {"row_block": linear_row_index(mesh, spec.row_axes),
            "R": _np(R), "P_rows": _np(P),
            "P": _np(replicate(mesh, P, spec))}


def job_dense_mesh_fits(shape, Y, runs):
    """`Embedding(backend="dense-mesh")` fits on a mesh of `shape`, one a
    run ({name: (spec fields, X0)})."""
    mesh = Mesh(shape)
    out = {}
    for name, (fields, X0) in runs.items():
        emb = Embedding(EmbedSpec(**fields), device="cpu", mesh=mesh).fit(
            Y, X0=_t(X0))
        res = emb.result_
        out[name] = {"energies": res.energies, "step_sizes": res.step_sizes,
                     "n_fevals": res.n_fevals, "X": _np(emb.embedding_),
                     "backend": emb.backend_,
                     "affinities": emb.affinities_}
    return out


def job_dense_mesh_api(Y, n_odd):
    """`auto`'s pick in this group and the dense-mesh backend's refusals:
    aff=, saff=, an N that the mesh does not divide."""
    mesh = make_host_mesh()
    spec = EmbedSpec(kind="ee", lam=10.0, backend="dense-mesh",
                     perplexity=5.0, max_iters=2)
    auto = Embedding(EmbedSpec(), device="cpu")
    return {
        "auto": {n: auto._resolve_backend(n)
                 for n in (2046, 2047, 2048, 2049)},
        "errors": {
            "aff": _raised(lambda: Embedding(spec, device="cpu").fit(
                Y, aff=object())),
            "saff": _raised(lambda: Embedding(spec, device="cpu").fit(
                Y, saff=object())),
            "indivisible": _raised(lambda: Embedding(
                spec, device="cpu", mesh=mesh).fit(Y[:n_odd])),
        },
    }


JOBS = {"energy_grad": job_energy_grad, "operator": job_operator,
        "fit": job_fit, "budget": job_budget, "api": job_api,
        "resume": job_resume, "mesh_groups": job_mesh_groups,
        "dense_eg": job_dense_eg, "block_jacobi": job_block_jacobi,
        "dense_mesh_fits": job_dense_mesh_fits,
        "dense_mesh_api": job_dense_mesh_api}
