"""Rank side of tests/test_torch_sharding.py,
tests/test_torch_distributed_embed.py, tests/test_torch_lm_sharding.py,
tests/test_torch_lm_tensor_parallel.py, tests/test_torch_lm_serve_mesh.py,
tests/test_torch_lm_expert_parallel*.py and
tests/test_torch_lm_ssm_parallel*.py:
the port's mesh backends (the row-sharded sparse one and the 2-D-sharded
dense one), its meshes, the LM's sharded train step, its collectives and
its sharded prefill and decode run inside a gloo process group on the CPU.
It holds no tests itself.

Spawned by `spawn_ranks`, one process per rank; it imports only torch and
repro_torch (JAX's side is computed in the test process and handed over as
numpy).  Each rank runs the jobs it is given and writes its results, as
numpy, to `<out_dir>/rank<r>.pt`.
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def float_as_double():
    """`Tensor.float` a float64 cast while open: every float32 cast of the
    port's (the SSM states' included) is then a float64 one."""
    narrow = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **kw: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = narrow


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


def job_lm_train(arch, compute, run, opt, state, batches, ckdir):
    """The LM train step on a (2, 2) mesh from JAX's state, three of
    JAX's batches, a save of the gathered state (rank 0), a restore onto a
    (4, 1) mesh through `sharding_tree` and a fourth step: the losses and
    the whole states after steps 3 and 4 (gathered on every rank)."""
    from repro_torch.ckpt import Checkpointer
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.launch.train import state_shardings
    from repro_torch.models import (build_model, init_train_state,
                                    make_train_step)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_map

    import dataclasses
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=compute)
    model = build_model(cfg, RunConfig(**run))
    opt = AdamWConfig(**opt)
    _, axes = init_train_state(model, 0, device="meta")
    whole = convert.lm_tree_from_numpy(state, "cpu")
    batches = [convert.lm_tree_from_numpy(b, "cpu") for b in batches]

    def gathered(st, sh):
        return tree_map(lambda s, x: s.gather(x), sh, st)

    mesh = Mesh({"data": 2, "model": 2})
    sh = state_shardings(mesh, axes, whole)
    st = tree_map(lambda s, x: s.shard(x), sh, whole)
    step = make_train_step(model, opt, grad_shardings=sh["params"])
    losses = []
    for b in batches[:3]:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    state3 = gathered(st, sh)
    ck = Checkpointer(ckdir)
    if mesh.rank == 0:
        ck.save(3, state3)
    dist.barrier()

    mesh = Mesh({"data": 4, "model": 1})
    fresh, _ = init_train_state(model, 1, device="cpu")
    sh = state_shardings(mesh, axes, fresh)
    st = ck.restore(3, tree_map(lambda s, x: s.shard(x), sh, fresh),
                    sharding_tree=sh)
    step3 = int(st["step"])
    step = make_train_step(model, opt, grad_shardings=sh["params"])
    st, m = step(st, batches[3])
    losses.append(float(m["loss"]))
    return {"losses": losses, "state3": state3, "state4": gathered(st, sh),
            "step3": step3, "step4": int(st["step"])}


def _lm_mesh_state(arch, compute, run, state, cfg_kw):
    import dataclasses

    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.models import build_model, init_train_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=compute)
    if cfg.num_experts:        # tests/test_torch_lm_models.py's smoke()
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    # the overrides last: a case may set its own capacity factor
    cfg = dataclasses.replace(cfg, **cfg_kw)
    model = build_model(cfg, RunConfig(**run))
    if state is None:
        return model, None, None
    _, axes = init_train_state(model, 0, device="meta")
    # copies: the step writes into the blocks, and a whole block is the
    # tensor itself, which may share the numpy array's memory
    whole = convert.lm_tree_from_numpy(state, "cpu")
    return model, axes, tree_map(lambda t: t.clone(), whole)


def job_lm_mesh_steps(runs, opt):
    """For each run ({name: (arch, config overrides, compute, run kwargs,
    mesh shape, JAX's state, JAX's batches)}): the sharded step from JAX's
    state on that
    mesh, a step a batch, and after each step the losses, grad norms and
    the whole state gathered from the blocks."""
    from repro_torch.launch.train import state_shardings
    from repro_torch.models import make_train_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_map

    out = {}
    for name, (arch, cfg_kw, compute, run, shape, state,
               batches) in runs.items():
        model, axes, whole = _lm_mesh_state(arch, compute, run, state,
                                            cfg_kw)
        mesh = Mesh(shape)
        sh = state_shardings(mesh, axes, whole)
        st = tree_map(lambda s, x: s.shard(x), sh, whole)
        step = make_train_step(model, AdamWConfig(**opt),
                               grad_shardings=sh["params"])
        rec = {"losses": [], "norms": [], "states": []}
        for b in batches:
            st, m = step(st, convert.lm_tree_from_numpy(b, "cpu"))
            rec["losses"].append(float(m["loss"]))
            rec["norms"].append(float(m["grad_norm"]))
            # copies: a whole block is the state's own tensor, which the
            # next step writes into
            rec["states"].append(tree_map(lambda s, x: s.gather(x).clone(),
                                          sh, st))
        out[name] = rec
    return out


def job_lm_serve_mesh(runs):
    """For each run ({name: (arch, config overrides, compute, mesh shape,
    JAX's params, the prompt batch, max_len, [(JAX's caches before a
    decode step, its tokens)])}): the sharded prefill from JAX's params
    cut into blocks, then each decode step from JAX's caches cut into
    blocks.  Returns, for the prefill and each step, the logits of every
    row (gathered over the FSDP axes) and the caches gathered from the
    blocks, and the spec of the first KV cache's k (without one, of the
    first cache leaf)."""
    from repro_torch.configs import RunConfig
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  tree_shardings)
    from repro_torch.models import (make_decode_step, make_prefill,
                                    params_specs)
    from repro_torch.tree import leaves, tree_map

    out = {}
    for name, (arch, cfg_kw, compute, shape, params, batch, max_len,
               steps) in runs.items():
        model, _, _ = _lm_mesh_state(arch, compute, dict(remat="none"),
                                     None, cfg_kw)
        mesh = Mesh(shape)
        whole = convert.lm_tree_from_numpy(params, "cpu")
        sh = tree_shardings(mesh, params_specs(model)[1], whole)
        blocks = tree_map(lambda s, x: s.shard(x), sh, whole)
        batch = convert.lm_tree_from_numpy(batch, "cpu")
        B = batch["tokens"].shape[0]
        csh = model.cache_shardings(mesh, B, max_len)
        rows = batch_shardings(mesh, {"t": batch["tokens"]})["t"]
        kv = next((c["k"] for c in csh["slots"] + [csh.get("shared_attn")]
                   if c is not None and "slot_pos" in c), leaves(csh)[0])

        def record(logits, caches):
            return (rows.gather(logits),
                    tree_map(lambda s, x: s.gather(x), csh, caches))

        logits, caches = make_prefill(model, sh, max_len)(blocks, batch)
        # the shapes of this rank's cache blocks
        rec = {"spec": kv.spec, "steps": [record(logits, caches)],
               "blocks": tree_map(lambda x: tuple(x.shape), caches)}
        decode = make_decode_step(model, sh, csh)
        for caches, tokens in steps:
            caches = tree_map(lambda s, x: s.shard(x), csh,
                              convert.lm_tree_from_numpy(caches, "cpu"))
            rec["steps"].append(record(*decode(
                blocks, caches, convert.lm_tree_from_numpy(tokens, "cpu"))))
        out[name] = rec
    return out


def job_collectives(seed):
    """On a (2, 2) mesh: each collective's forward and backward (upstream
    gradients drawn per rank from `seed + rank`), the vocab-parallel
    embedding (gather and one-hot, one table and stacked codebook tables)
    and cross-entropy under the tensor-parallel context against the whole
    ones, `global_norm` over blocks with leaves replicated over "model" and
    over every rank, and the activation constraint's re-lays."""
    import types

    from repro_torch.configs import RunConfig
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (make_activation_constraint,
                                                  tree_shardings)
    from repro_torch.models import hooks, layers, model as lm_model
    from repro_torch.models.train import _Sharded
    from repro_torch.optim.adamw import global_norm

    mesh = Mesh({"data": 2, "model": 2})
    tp = C.TensorParallel(mesh, {})
    rank = mesh.rank
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn(4, 6, generator=gen)                # the same on all
    mine = torch.Generator().manual_seed(seed + 1 + rank)
    G = torch.randn(4, 6, generator=mine)               # this rank's
    out = {"rank": rank, "coords": mesh.coords, "G": G}

    def run(name, fn, x, g):
        x = x.detach().clone().requires_grad_(True)
        y = fn(x)
        y.backward(g)
        out[name] = (y.detach(), x.grad)

    blk = X.narrow(1, 3 * mesh.coords["model"], 3)
    run("gather", lambda x: C.gather(x, 1, tp.model), blk, G)
    run("copy_to", lambda x: C.copy_to(x, tp.model), X, G)
    run("reduce_from", lambda x: C.reduce_from(x, tp.model), X + rank, G)
    run("gather_from", lambda x: C.gather_from(x, 1, tp.model), blk, X)
    run("scatter_to", lambda x: C.scatter_to(x, 1, tp.model), X,
        G.narrow(1, 0, 3))
    run("gather_fsdp", lambda x: C.gather(x, 0, tp.fsdp),
        X.narrow(0, 2 * mesh.coords["data"], 2), G)

    # the vocab-parallel embedding and loss ("model" = 2: vocab blocks of 8)
    V, D = 16, 5
    cfg = types.SimpleNamespace(vocab_size=V, compute_dtype="float32")
    table = torch.randn(V, D, generator=gen)
    tables = torch.randn(3, V, D, generator=gen)
    tok = torch.randint(0, V, (2, 7), generator=gen)
    tok3 = torch.randint(0, V, (2, 7, 3), generator=gen)
    logits = torch.randn(2, 7, V, generator=gen)
    vb = 8 * mesh.coords["model"]
    emb = {}
    with hooks.tensor_parallel_scope(tp):
        for name, fn, t, tk in (
                ("gather", layers.embed_tokens, table, tok),
                ("onehot", layers.embed_tokens_onehot, table, tok),
                ("codebooks", layers.embed_tokens, tables, tok3),
                ("codebooks_onehot", layers.embed_tokens_onehot, tables,
                 tok3)):
            b = t.narrow(-2, vb, 8).clone().requires_grad_(True)
            y = fn({"table": C.mark(b, b.ndim - 2)}, cfg, tk)
            y.backward(torch.ones_like(y))
            emb[name] = (y.detach(), b.grad)
        lb = logits.narrow(-1, vb, 8).clone().requires_grad_(True)
        labels = torch.randint(0, V, (2, 7), generator=gen)
        ce = lm_model._vocab_parallel_ce(lb, labels)
        ce.backward()
        out["ce"] = (float(ce), lb.grad)
        out["ce_inputs"] = (logits, labels)
    out["embed"] = emb
    out["embed_inputs"] = (table, tables, tok, tok3)

    # global_norm over blocks: a leaf split over both axes, one over the
    # FSDP axis only (held alike by the "model" ranks), one whole
    shapes = {"a": torch.empty(8, 6), "b": torch.empty(8), "c": torch.empty(5)}
    axes = {"a": ("embed", "mlp"), "b": ("embed",), "c": (None,)}
    sh = tree_shardings(mesh, axes, shapes)
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in shapes.items()}
    dp = _Sharded(sh)
    blocks = [s.shard(grads[k]) for k, s in sorted(sh.items())]
    out["norm"] = (float(dp.global_norm(blocks)), float(global_norm(grads)))

    # the activation constraint: re-lays under the context on "model" = 2
    fn = make_activation_constraint(mesh, RunConfig())
    q = torch.randn(2, 3, 4, 5, generator=gen)      # 4 heads: split on 2
    r = torch.randn(2, 3, 8, generator=gen)
    relay = {"outside": fn(q, "qkv") is q}
    hooks.set_activation_constraint(fn)
    try:
        with hooks.tensor_parallel_scope(tp):     # passes `tp` to `fn`
            y = hooks.constrain(C.mark(q.clone(), None), "qkv")
    finally:
        hooks.set_activation_constraint(None)
    relay["qkv"] = (y, C.model_split(y))
    relay["unmarked"] = fn(q, "qkv", tp) is q
    res = C.mark(r.narrow(-1, 4 * mesh.coords["model"], 4).clone(), 2)
    relay["residual"] = fn(res, "residual", tp) is res
    relay["moe"] = fn(q, "moe_dispatch", tp) is q
    relay["same"] = fn(r, "residual", tp) is r
    relay["inputs"] = (q, r)
    out["relay"] = relay
    return out


def job_moe_grad(cases):
    """For each case ({name: (arch, config overrides, mesh shape, one MoE
    layer's whole params, x (B, S, D), the upstream gradient (B, S, D))}):
    the MoE layer under the tensor-parallel context on this rank's blocks
    of the params and its rows of x, and the gradient of the sum of its
    output times the upstream gradient.  Returns the output and x's
    gradient (every row, gathered over the FSDP axes), the params'
    gradients gathered from the blocks' and the "model" split dim of each
    leaf as the layer reads it."""
    from repro_torch.distributed.collectives import (TensorParallel,
                                                     model_split)
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  tree_shardings)
    from repro_torch.models import hooks
    from repro_torch.models.layers import _MetaKey
    from repro_torch.models.moe import init_moe, moe_ffn
    from repro_torch.tree import tree_map

    out = {}
    for name, (arch, cfg_kw, shape, params, x, g) in cases.items():
        model, _, _ = _lm_mesh_state(arch, "float32", dict(remat="none"),
                                     None, cfg_kw)
        mesh = Mesh(shape)
        _, axes = init_moe(_MetaKey(), model.cfg)
        whole = convert.lm_tree_from_numpy(params, "cpu")
        sh = tree_shardings(mesh, axes, whole)
        blocks = tree_map(lambda s, t: s.shard(t).clone().requires_grad_(),
                          sh, whole)
        rows = batch_shardings(mesh, {"x": _t(x)})["x"]
        xr = rows.local_view(_t(x)).clone().requires_grad_()
        tp = TensorParallel(mesh, sh)
        with hooks.tensor_parallel_scope(tp):
            p = tp.gather_params(blocks, sh)
            y = moe_ffn(p, model.cfg, xr)
        (y * rows.local_view(_t(g))).sum().backward()
        out[name] = {
            "y": rows.gather(y.detach()), "x_grad": rows.gather(xr.grad),
            "grads": tree_map(lambda s, b: s.gather(b.grad), sh, blocks),
            "split": tree_map(model_split, p)}
    return out


def job_ssm_grad(cases):
    """For each case ({name: (arch, config overrides, mesh shape, mixer
    "tm", "cm" or "mamba", its whole params, its whole state, x (B, S, D),
    the upstream gradient (B, S, D), trap)}): the mixer under the
    tensor-parallel context on this rank's blocks of the params (and of the
    state's heads), and the gradient of the sum of its output times the
    upstream gradient.  `trap` puts a wrong collective in: "gather_from"
    gathers `in_proj` and the conv over "model" with `gather_from` (its
    backward keeps this rank's slice of its own partial gradient),
    "reduce_from" takes the RMSNorm's mean square with `reduce_from`
    (identity backward); None runs the port as it is.  Returns the output,
    x's gradient, the new state (the heads gathered over "model"), the
    params' gradients gathered from the blocks and each leaf's "model"
    split dim as the mixer reads it."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.models import hooks, ssm
    from repro_torch.models.layers import _MetaKey
    from repro_torch.tree import tree_map

    init = {"tm": ssm.init_rwkv6_time_mix, "cm": ssm.init_rwkv6_channel_mix,
            "mamba": ssm.init_mamba2}
    apply = {"tm": ssm.rwkv6_time_mix, "cm": ssm.rwkv6_channel_mix,
             "mamba": ssm.mamba2}
    out = {}
    for name, (arch, cfg_kw, shape, mixer, params, state, x, g,
               trap) in cases.items():
        model, _, _ = _lm_mesh_state(arch, "float32", dict(remat="none"),
                                     None, cfg_kw)
        mesh = Mesh(shape)
        _, axes = init[mixer](_MetaKey(), model.cfg)
        whole = convert.lm_tree_from_numpy(params, "cpu")
        sh = tree_shardings(mesh, axes, whole)
        blocks = tree_map(lambda s, t: s.shard(t).clone().requires_grad_(),
                          sh, whole)
        tp = C.TensorParallel(mesh, sh)
        st = convert.lm_tree_from_numpy(state, "cpu")
        heads = [k for k in ("wkv", "ssm") if k in st]
        for k in heads:
            st[k] = C.local_slice(st[k], 1, tp.model)
        xr = _t(x).clone().requires_grad_()
        saved = ssm._whole_on_model
        if trap == "gather_from":
            ssm._whole_on_model = lambda w: tp.gather_from_model(
                w, C.model_split(w))
        if trap == "reduce_from":
            tp.psum_model = tp.reduce_from_model
        try:
            with hooks.tensor_parallel_scope(tp):
                p = tp.gather_params(blocks, sh)
                y, new = apply[mixer](p, model.cfg, xr, st)
        finally:
            ssm._whole_on_model = saved
        (y * _t(g)).sum().backward()
        new = {k: (C.all_gather(v.detach(), 1, tp.model) if k in heads
                   else v.detach()) for k, v in new.items()}
        out[name] = {
            "y": y.detach(), "x_grad": xr.grad, "state": new,
            "grads": tree_map(lambda s, b: s.gather(b.grad), sh, blocks),
            "split": tree_map(C.model_split, p)}
    return out


def job_lm_mesh_f64(runs):
    """For each run ({name: (arch, config overrides, mesh shape)}), in
    float64: the params and compute in float64 under `float_as_double`,
    the one-rank step and the
    sharded step from `init_train_state(0)` on three batches.  Returns each
    step's losses and the largest gap of a leaf of the whole state
    (gathered) from the one rank's, of that leaf's scale."""
    import dataclasses

    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for
    from repro_torch.launch.train import state_shardings
    from repro_torch.models import (build_model, init_train_state,
                                    make_train_step)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves, tree_map

    out = {}
    with float_as_double():
        for name, (arch, cfg_kw, shape) in runs.items():
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      param_dtype="float64",
                                      compute_dtype="float64", **cfg_kw)
            model = build_model(cfg, RunConfig(num_microbatches=2,
                                               remat="full",
                                               moment_dtype="float64"))
            ref, axes = init_train_state(model, 0, device="cpu")
            mesh = Mesh(shape)
            sh = state_shardings(mesh, axes, ref)
            st = tree_map(lambda s, x: s.shard(x).clone(), sh, ref)
            opt = AdamWConfig(warmup_steps=2, total_steps=10)
            one = make_train_step(model, opt)
            step = make_train_step(model, opt, grad_shardings=sh["params"])
            rec = []
            for k in range(3):
                batch = batch_for(cfg, ShapeConfig("t", "train", 16, 8),
                                  step=k, device="cpu")
                ref, m1 = one(ref, batch)
                st, m2 = step(st, batch)
                whole = tree_map(lambda s, x: s.gather(x), sh, st)
                gap = max(float((a - b).abs().max() / a.abs().max())
                          for a, b in zip(leaves(ref), leaves(whole))
                          if a.is_floating_point() and a.abs().max() > 0)
                rec.append((float(m1["loss"]), float(m2["loss"]), gap))
            out[name] = rec
    return out


def job_ssm_gathers(runs):
    """For each run ({name: (arch, config overrides, mesh shape)}): a
    sharded train step, prefill and decode step from `init_params(0)`,
    with every all-gather over "model" recorded: (the shape of the tensor
    that a rank gives, the dim), in `collectives` and `ssm.py`."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_shardings
    from repro_torch.launch.train import state_shardings
    from repro_torch.models import (init_train_state, make_decode_step,
                                    make_prefill, make_train_step, ssm)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import tree_map

    out = {}
    for name, (arch, cfg_kw, shape) in runs.items():
        model, _, _ = _lm_mesh_state(arch, "float32",
                                     dict(num_microbatches=1, remat="full"),
                                     None, cfg_kw)
        mesh = Mesh(shape)
        model_ax = C.mesh_axis(mesh, ("model",))
        seen = []
        plain = C.all_gather

        def spy(x, dim, ax):
            if ax.group is model_ax.group:
                seen.append((tuple(x.shape), dim % x.ndim))
            return plain(x, dim, ax)

        state, axes = init_train_state(model, 0, device="cpu")
        sh = state_shardings(mesh, axes, state)
        state = tree_map(lambda s, x: s.shard(x).clone(), sh, state)
        cfg = model.cfg
        batch = batch_for(cfg, ShapeConfig("t", "train", 8, 4), device="cpu")
        psh = tree_shardings(mesh, axes, model.init_params(
            0, device="meta")[0])
        C.all_gather = ssm.all_gather = spy
        try:
            make_train_step(model, AdamWConfig(),
                            grad_shardings=sh["params"])(state, batch)
            train = list(seen)
            seen.clear()
            params = tree_map(lambda s, x: s.shard(x),
                              psh, model.init_params(0, device="cpu")[0])
            csh = model.cache_shardings(mesh, 4, 10)
            _, caches = make_prefill(model, psh, 10)(
                params, {"tokens": batch["tokens"][:, :8]})
            make_decode_step(model, psh, csh)(params, caches,
                                              batch["tokens"][:, 8:9])
        finally:
            C.all_gather = ssm.all_gather = plain
        out[name] = {"train": train, "serve": list(seen)}
    return out


JOBS = {"energy_grad": job_energy_grad, "operator": job_operator,
        "fit": job_fit, "budget": job_budget, "api": job_api,
        "resume": job_resume, "mesh_groups": job_mesh_groups,
        "dense_eg": job_dense_eg, "block_jacobi": job_block_jacobi,
        "dense_mesh_fits": job_dense_mesh_fits,
        "dense_mesh_api": job_dense_mesh_api, "lm_train": job_lm_train,
        "lm_mesh_steps": job_lm_mesh_steps, "collectives": job_collectives,
        "lm_serve_mesh": job_lm_serve_mesh, "moe_grad": job_moe_grad,
        "ssm_grad": job_ssm_grad, "ssm_gathers": job_ssm_gathers,
        "lm_mesh_f64": job_lm_mesh_f64}
