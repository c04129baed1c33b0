"""Training launcher: mesh, sharded state, synthetic data, checkpoint and
auto-resume, elastic re-shard, straggler watchdog.

Port of `repro/launch/train.py`.  The command line runs any arch's smoke
config (`--smoke` is always on, as `launch/serve.py`'s; `train_lm` takes a
full config) on the default process group's mesh, one started here when
the caller has none (one rank: gloo on the CPU, NCCL on a GPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --steps 20 --ckpt results/train_ckpt --device cpu

On a mesh of several ranks the step is the sharded program of
`models/train.py`: each rank holds its blocks of the params, moments and
gradients (`state_shardings`), gathers a layer group's blocks over the
FSDP axes ("pod", "data") as the group runs and computes the projections
on their "model" blocks: `--model-axis m` lays the ranks out as
(world / m, m) and splits the GEMMs m ways.  The ranks' processes are the
caller's (torchrun, or `torch.multiprocessing` with a gloo group on the
CPU).

Elastic: train on one mesh, re-run on another (another `--model-axis`, or
another number of ranks under `torchrun`): the checkpoint restores with the
new mesh's shardings (`Checkpointer.restore(..., sharding_tree=)`), since
it holds whole arrays.  Rank 0 writes the checkpoints.

A step is timed to its end on the card (a device wait in `explicit_read`,
as the reference's `block_until_ready`); the loss printed every 5 steps is
the step's one host read (`analysis.guards.explicit_read`).
"""
from __future__ import annotations

import argparse
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.guards import explicit_read
from repro_torch.api.estimator import resolve_device
from repro_torch.ckpt import Checkpointer
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import batch_for
from repro_torch.distributed.sharding import (make_activation_constraint,
                                              scalar_sharding, tree_shardings)
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build_model, hooks, make_train_step
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import leaves, tree_map


def state_shardings(mesh, axes, state):
    return {
        "params": tree_shardings(mesh, axes, state["params"]),
        "opt": {
            "m": tree_shardings(mesh, axes, state["opt"]["m"]),
            "v": tree_shardings(mesh, axes, state["opt"]["v"]),
            "count": scalar_sharding(mesh),
        },
        "step": scalar_sharding(mesh),
    }


def init_sharded_state(model, mesh, device) -> tuple[dict, dict, int]:
    """(this rank's blocks of the initial train state, the state's
    shardings, the number of params): params from `init_params(0)` on
    `device`, cut into blocks leaf by leaf (the whole params exist only
    until they are cut), moments made as blocks."""
    params, axes = model.init_params(0, device=device)
    n_params = sum(p.numel() for p in leaves(params))
    sh = state_shardings(mesh, axes, {"params": params,
                                      "opt": {"m": params, "v": params}})
    params = tree_map(lambda s, x: s.shard(x), sh["params"], params)
    state = {"params": params,
             "opt": adamw.init(params, moment_dtype=model.run.moment_dtype),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    return state, sh, n_params


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        with explicit_read():
            torch.cuda.synchronize(device)


def train_lm(cfg: ModelConfig, run: RunConfig, opt: AdamWConfig, *,
             steps: int, batch: int, seq: int, mesh, ckpt=None,
             ckpt_every: int = 10, device=None, log=print) -> dict:
    """Train `cfg` for `steps` steps (from the checkpoint's step when
    `ckpt`, a `Checkpointer`, holds one) on `mesh`, a batch of `batch`
    sequences of `seq` tokens a step from `batch_for`.  Params start from
    `init_params(0)` on `device` (the reference's `PRNGKey(0)`); each rank
    keeps its blocks of them (`init_sharded_state`); `log` takes the
    printed lines.
    Returns the state (this rank's blocks), the losses and grad norms read
    (device tensors, a step each), the step seconds and the first step."""
    device = resolve_device(device)
    model = build_model(cfg, run)
    hooks.set_activation_constraint(make_activation_constraint(mesh, run))
    try:
        state, sh, n_params = init_sharded_state(model, mesh, device)
        start = 0
        if ckpt is not None:
            latest = ckpt.latest_step()
            if latest is not None:
                # elastic restore: whatever mesh we have NOW
                state = ckpt.restore(latest, state, sharding_tree=sh)
                start = latest
                log(f"resumed step {latest} (elastic re-shard onto "
                    f"{dict(mesh.shape)})")
        log(f"mesh {dict(mesh.shape)} arch {cfg.name}")
        log(f"params {n_params / 1e6:.2f}M")

        step_fn = make_train_step(model, opt, grad_shardings=sh["params"])
        shape = ShapeConfig("train", "train", seq, batch)
        losses, norms, step_times = [], [], []
        for step in range(start, steps):
            inputs = batch_for(cfg, shape, step=step, device=device)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, inputs)
            _wait(device)
            dt = time.perf_counter() - t0
            step_times.append(dt)
            losses.append(metrics["loss"])
            norms.append(metrics["grad_norm"])
            if len(step_times) > 5 and dt > 3.0 * float(
                    np.median(step_times)):
                log(f"  [watchdog] straggling step {step}: {dt:.2f}s")
            if step % 5 == 0 or step == steps - 1:
                with explicit_read():
                    loss = float(metrics["loss"])
                log(f"step {step:4d} loss {loss:.4f} ({dt:.2f}s)")
            if ckpt is not None and (step + 1) % ckpt_every == 0:
                _save(ckpt, step + 1, state, sh, mesh)
        if ckpt is not None and start < steps:
            _save(ckpt, steps, state, sh, mesh)
            ckpt.wait()
            if mesh.size > 1:
                dist.barrier()      # the last checkpoint is on disk for all
    finally:
        hooks.set_activation_constraint(None)
    return {"state": state, "losses": losses, "grad_norms": norms,
            "step_s": step_times, "start": start, "shardings": sh}


def _save(ckpt, step: int, state, sh, mesh) -> None:
    """Rank 0 writes the whole state; every rank takes part in the
    gathers."""
    whole = tree_map(lambda s, x: s.gather(x), sh, state)
    if mesh.rank == 0:
        ckpt.save(step, whole)


def _start_group(device: torch.device) -> bool:
    """A one-rank process group for the command line when none is started
    (the caller's launcher, e.g. torchrun, starts one otherwise); True if
    this call started it."""
    if dist.is_initialized():
        return False
    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    return True


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=20)
    # store_true with default True: the command line always runs the smoke
    # config (train_lm takes a full config)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the current "
                         "CUDA device; 'cpu' for the CPU)")
    a = ap.parse_args(argv)

    device = resolve_device(a.device)
    started = _start_group(device)
    try:
        cfg = get_smoke_config(a.arch)
        run = RunConfig(num_microbatches=a.microbatches, remat="full")
        mesh = (make_production_mesh(multi_pod=a.multi_pod)
                if a.production_mesh else make_host_mesh(a.model_axis))
        ckpt = (Checkpointer(a.ckpt, keep=3, async_save=True) if a.ckpt
                else None)
        opt = AdamWConfig(warmup_steps=5, total_steps=max(a.steps, 10))
        train_lm(cfg, run, opt, steps=a.steps, batch=a.batch, seq=a.seq,
                 mesh=mesh, ckpt=ckpt, ckpt_every=a.ckpt_every,
                 device=device)
        print("done")
    finally:
        if started:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
