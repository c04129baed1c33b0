#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) and failing the run on error:

  1. probe  — torch/CUDA versions, the device, nvcc, nvidia-smi.
  2. build  — compile the CUDA kernels from src/repro_torch/kernels/csrc,
              one nvcc per source, all started together.
  3. check  — each kernel against its plain PyTorch version in float64:
              the pairwise kernel for all five kinds, float32 and bfloat16
              storage, ragged and aligned N (one column tile and several),
              several d; the ELL kernel in both layouts, float32 and
              bfloat16, N in {1000, 4096, 4097}, k in {1, 24, 40, 90, 229,
              386} (every lane-slot bucket of the direct gather and its
              passes of 256 slots), d in {1, 2, 3, 4, 8}, with padding
              slots, all-padding rows, a repeated column and self loops.
              Reruns must be bit-identical, and the staged gather (hbm)
              must give the direct gather's (vmem) bits.
  4. fit    — slice 1's main path at full width: `Embedding(EmbedSpec(
              backend="dense", strategy="sd"))` on MNIST-shaped data
              (N = 20000, D = 784, perplexity 30), EE (lambda = 100,
              kappa = 7) and t-SNE (lambda = 1), ten iterations each.  The
              kernel's launch counter must grow, the energies must be finite
              and must not increase, and the first three iterations must
              match the plain-PyTorch path at rtol 1e-4.
  5. time   — the pairwise kernel at N = 20000, d = 2, every kind, float32
              and bfloat16, on the fits' own embeddings and affinities (EE's
              for the unnormalized kinds, t-SNE's for the normalized ones),
              device time by CUDA-graph replay and the time of a call
              issued eagerly, beside its memory bound and the plain version;
              each call is held against the plain version.
  6. profile — three dense SD iterations of the t-SNE fit under
              torch.profiler: device time by kernel and the idle share.
 6a. fit_lineup — the rest of the paper's dense lineup from phase fit's
              affinities and spectral starts:
              `Embedding(EmbedSpec(backend="dense", strategy=s))` for s in
              diag, cg, lbfgs and sd-, EE (lambda = 100) and t-SNE (lambda =
              1), five iterations each: one kernel launch an energy
              evaluation, finite energies that never increase, and the first
              three iterations against the plain path at rtol 1e-4. On EE,
              DiagH and CG are held from phase fit's settled embedding (from
              the spectral start they take GD's steps, whose third amplifies
              float32 rounding: there the plain path must itself part from a
              float64 run of it wherever the kernel path parts from it) and
              SD- at lambda = 1; each held trace must part from GD's by more
              than 1e-4 on EE, and L-BFGS must store a pair there (on t-SNE a
              line says where only the -G path was checked). Then SparseSD (k
              = 7) on the EE problem through `_minimize`, five iterations: it
              launches the default ELL layout, and one direction equals the
              same PCG solve on the plain ELL product (max |diff| / max |P|
              1e-4); then `homotopy_path` with SD over three log-spaced stages
              to lambda = 100, at most three iterations each: every stage
              descends. It prints each method's set-up seconds (its
              strategy.init), ms and energy evaluations per iteration and peak
              device memory.
  7. fit_sparse — slice 2's main path: `Embedding(EmbedSpec(kind=...,
              strategy="sd"))` with the default backend="auto" on
              `mnist_like(n=70000, dim=784)` (the full MNIST set; perplexity
              30, so k = 90; five negatives; approximate kNN), EE
              (lambda = 100) and t-SNE (lambda = 1), ten iterations each.
              The backend must resolve to sparse, the ELL kernel's launch
              counter must grow, the energies must be finite with the last
              surrogate below the first, and the first three iterations
              must match a kernel_impl="torch" run with the same draws at
              rtol 1e-4; that run must launch no ELL kernel.  The default
              fits launch the default layout (`ops.ELL_DEFAULT_LAYOUT`)
              only.  Then the EE fit's objective again with the CG operator
              on the other layout (`build_sparse_objective(ell_layout=)`,
              which no user option selects), driven by the same engine:
              its energies must be the default fit's, bit for bit.
  8. time_ell — each ELL layout on the fits' forward and reverse graphs,
              float32 and bfloat16: device time by CUDA-graph replay and
              eager time, the memory bound, the plain version and
              torch.sparse.mm on the CSR Laplacian (both eager); each
              call held against the float64 plain version.  Beside the
              vmem time, the gathers N k and their L2 sectors (N k x 32
              bytes); on the EE forward graph, the vmem kernel again with
              every index set to its own row (the graph streamed, no
              scattered gather) and folded into rows [0, 1024) (every
              gather an L1 hit): what the gathers cost.  Beside the hbm
              time, its gathers (the slots not of the row's own index),
              its share of the bound and the staged gather's first
              design's time; then the layout that the rule "the staged
              gather wins on every graph and storage" picks, beside the
              default (`ops.ELL_DEFAULT_LAYOUT`, set by hand; the closing
              summary warns when the two differ).
  9. profile_sparse — three sparse t-SNE SD iterations under
              torch.profiler: device time by kernel and the idle share.
 10. check_bh — the Barnes-Hut cell-interaction kernel against its float64
              plain version: five kinds, float32 and bfloat16, N in {1000,
              4097}, W in {1, 25, 96, 128}, d in {1, 2, 3}, tables of 16 and
              65536 rows and the table = X case, with zero-weight slots,
              all-zero rows (exactly 0) and a repeated index; reruns must be
              bit-identical.  Then the tree's partition invariant on the
              card: tree_pairs == N (N - 1) exactly at N = 4000.
 11. fit_tree — slice 3's main path at full width: `Embedding(EmbedSpec(
              kind=..., backend="tree", strategy="sd"))` on the N = 70000
              fits' affinities (`fit(saff=)`; theta = 0.5, depth 8, cap 16),
              EE (lambda = 100) and t-SNE (lambda = 1), ten iterations each.
              The fused kernel (`bh_tree`) must launch once an evaluation and
              the per-batch kernel (`bh_interaction`) never, the energies
              must be finite and must not increase, and a second kernel run
              of three iterations must be bit-identical; it prints the
              grid's diagnostics.  A rerun of three iterations through the
              per-batch kernel path (`_tree_repulsion_batched`, one launch a
              chunk of every batch, 12 an evaluation) must give the same
              bits.  The first three iterations must match, at the
              default mu_scale = 1e-5, a run with only the cell interaction
              on its plain version at rtol 1e-4, and a kernel_impl="torch"
              run (which launches no kernel) within 1e-3: there the
              near-singular SD system lets the order of the ELL products'
              float32 sums move the EE trajectory by ~2.2e-4 (PERF.md,
              Findings); at mu_scale = 1e-3 the kernel_impl="torch" run
              must match at rtol 1e-4.  Then every per-batch kernel call of
              one evaluation on each fit's embedding (EE: the exp
              instantiation; t-SNE: 1/(1 + t)), float32 and bfloat16,
              against the float64 plain version; and the fused kernel on
              the same embedding, bit-equal to those calls' sums (every
              batch's s row and F) and within the sum of their bounds of
              the float64 plain version.
 12. time_bh — the per-batch kernel at the tree's batch shapes on the
              t-SNE tree fit's embedding (far level 8, W = 96; a near
              chunk, W = 128 with table = X; the residual, W = 25), and the
              fused kernel over one whole evaluation, float32 and bfloat16:
              device time by CUDA-graph replay and the time of a call issued
              eagerly, beside the bound (the per-batch calls' bytes; the
              fused kernel's operations, counted from the window tests and
              live slots this evaluation needs) and the plain version, each call held against the
              float64 plain version; then one whole tree_repulsion through
              the per-batch path (before) and the fused path (after),
              against the grid state alone and the expansion alone.
 13. profile_tree — three tree t-SNE SD iterations under torch.profiler:
              device time by kernel, the fused kernel's line and the idle
              share.
 14. check_ell_local — the local-rows ELL kernel of the sharded backend
              against its float64 plain version on the N = 70000 EE fit's
              forward (k = 90) and reverse graphs: rows [0, 70000) (one
              rank), [0, 35000) and [35000, 70000) (two), float32 and
              bfloat16, d in {1, 2, 3}, phase check_ell's bound (an all-zero
              output fails it); reruns must be bit-identical.
 15. fit_sharded — slice 5's main path: `Embedding(EmbedSpec(kind=...,
              backend="sparse-sharded"), mesh=...)` in a one-rank NCCL group
              (this card) started in-process through a file:// store, on
              phase fit_sparse's data and settings, EE (lambda = 100) and
              t-SNE (lambda = 1), ten iterations each.  It must launch the
              local-rows kernel and no other ELL kernel, build the sparse
              fits' graph and start, stay within 1e-3 of the sparse fits'
              energies at the default mu_scale, and, over five iterations at
              mu_scale = 1e-3, within rtol 1e-4 of the single-device sparse
              fit and of its own kernel_impl="torch" run (which launches no
              kernel).
 16. fit_sharded_2rank — two spawned ranks on this card over gloo (NCCL
              takes one rank a device), the t-SNE sharded fit, five
              iterations at mu_scale = 1e-3 from the one-rank fit's graph
              and start: rank 1 runs the kernel at row0 = 35000; both ranks'
              results must be bit-identical and within rtol 1e-4 of the
              one-rank trace; each rank must launch the kernel.
 17. time_ell_local — the local-rows kernel at nb = 35000 (row0 = 35000)
              and nb = 70000 on the EE fit's forward and reverse graphs,
              float32 and bfloat16: device time by CUDA-graph replay and
              eager time, the byte bound, the plain version and
              torch.sparse.mm on the shard's CSR Laplacian rows, each call
              held against the float64 plain version, and the gathers nb k
              with their L2 sectors; then the NCCL all-gather that
              re-replicates the (N, 2) slab, beside a zero-filled slab's
              all_reduce.
 17a. autotune — the launch-shape autotuner (kernels/autotune.py), its
              disk cache at the ignored build/chip_smoke_autotune/
              autotune.json (REPRO_AUTOTUNE_CACHE), cleared first: at every
              main-path shape (pairwise N = 20000 on the EE and t-SNE fits;
              the ELL direct and staged gathers on the EE fit's forward and
              reverse graphs at N = 70000; the local-rows kernel at nb =
              70000 and 35000; bh_tree on the t-SNE tree fit's grid),
              float32 and bfloat16, one line: the dispatch's search (the
              candidates' CUDA-event times, the pick, the search's seconds)
              or cache hit (shapes that share a key), a second lookup that
              must hit, every candidate's outputs bit-equal (torch.equal) to
              the fixed shape's, and the pick against the fixed shape by
              CUDA-graph replay in turns (fixed, pick, pick, fixed).  A fresh
              process on the same file must hit every key with the same
              pick.  Then the warmed dense SD (EE, N = 20000), sparse and
              sparse-sharded (t-SNE, N = 70000, the one-rank NCCL group)
              fits: one warm-up iteration, three under the sync-debug mode
              "warn" (every unsanctioned host wait listed by file and line:
              there must be none), three under
              `assert_compile_count(expected=0)` and
              `no_implicit_transfers()` (analysis/guards.py).  The searches'
              own launches are counted apart (`autotune.search_launches`)
              and printed by `done`, not in the kernels line.
 18. profile_sharded — three one-rank sharded t-SNE SD iterations under
              torch.profiler: device time by kernel, the idle share and the
              NCCL collectives' time a CG matvec.
 18a. fit_dense_mesh — the dense half of slice 5:
              `Embedding(EmbedSpec(backend="dense-mesh"), mesh=make_host_mesh())`
              in phase fit_sharded's one-rank NCCL group on phase fit's
              N = 20000 data from its spectral starts: SD on EE (lambda =
              100) and t-SNE (lambda = 1), ten iterations; FP and GD on EE,
              five.  The 2-D tile is plain torch, as the reference's is, so
              the fits must launch no pairwise kernel; their energies must
              not rise.  The tile's (E, G) at phase fit's settled EE
              embedding is held against kernel 1 through
              core.energy_and_grad at rtol 1e-4 (E) and 1e-4 in norm (G).
              Printed: ms and energy evaluations an iteration, the
              block-Jacobi set-up seconds, peak device memory, the resolved
              backend, and the tile's ms an evaluation (CUDA events) beside
              kernel 1's (CUDA-graph replay) on the same X and Wp.
 18b. fit_dense_mesh_4rank — four spawned gloo ranks on this card on a
              (2, 2) ("data", "model") mesh (`make_host_mesh(model_axis=2)`),
              N = 2048 `mnist_like`, the largest N for which `backend="auto"`
              picks dense-mesh (it must), SD on EE (lambda = 100) and t-SNE
              (lambda = 1), three iterations: the ranks' X and traces
              bit-equal, the mesh's (E, G) at the start within rtol 1e-5 of
              the one-rank mesh's.
 19. telemetry — slice 6's telemetry path: phase fit_sparse's t-SNE fit
              (N = 70000, k = 90, ten iterations) again from Y with
              `fit(telemetry=<dir>)`: its energies and X must be that fit's
              bit for bit; run.jsonl must hold ten iteration records with
              pcg_iters >= 1, pcg_residual, z_ema > 0 and the device's
              memory counters, the phase records graph-build,
              spectral-init, setup and compile, and a kernel_dispatch meta
              naming the ELL kernel's CUDA path and layout; trace.json must
              be Chrome-trace JSON with the graph build's steps
              (graph-build/knn, /calibrate, /reverse), ten solve-iter spans
              and kernel/ell_lap_matvec spans.  Printed: the median ms an
              iteration with and without telemetry and their ratio (not
              held), and the report CLI's rendering.  Then three
              iterations under torch.profiler with
              profiler_annotations=True: solve-iter user annotations beside
              the ELL kernel's CUDA events.
 20. resume — five fits stopped and resumed through a fresh
              `Embedding(spec).resume(Y, max_iters=...)`, each bit-equal
              after the checkpoint (energies and X) to its uninterrupted
              run and resumed from the step it stopped at: dense EE N =
              20000 SD (lambda = 100, kappa = 7) 5 -> 10 against phase
              fit's, from its spectral start (kernel 1; the payload holds
              SD's two N x N matrices, 3.2 GB); sparse t-SNE N = 70000 5 -> 10 against phase
              fit_sparse's (kernel 2; the z carry and the PCG warm start),
              with one telemetry directory whose run.jsonl must hold
              iterations 1..10; tree EE 2 -> 4 on phase fit_sparse's graph
              (kernel 4 through bh_tree; the deterministic (E, G) path);
              sparse-sharded t-SNE 2 -> 4 in the one-rank NCCL group
              (kernel 5); dense-mesh EE SD 5 -> 10 in the same group
              against phase fit_dense_mesh's (the plain tile; X and G are
              the payload, the block-Jacobi factor is built again).  Printed: each save's bytes and seconds (its
              checkpoint span).  The checkpoints live under the ignored
              build/chip_smoke_resume/, removed at the end.
 21. serve — slice 4's main path: the out-of-sample transform, artifacts
              and the server (`Embedding.transform`, `save` / `load`,
              `EmbeddingServer`, `python -m repro_torch.serve.http`) over
              the t-SNE sparse fit of phase fit_sparse (N = 70000, k = 90,
              m = 50 anchors, 100 iterations, approximate cross-kNN) and the
              EE dense fit of phase fit (N = 20000, exact cross-kNN; saved
              by phase fit as an artifact and loaded here), on 1024 queries
              (seeded training rows plus N(0, 0.1^2) noise).  Held: an
              exhaustive transform after save -> load on CUDA is the
              in-process one bit for bit; `embedding_` is unchanged after
              every request; each row's rowwise result alone, in pairs
              and in chunks of 5 (the first 8 rows of each check,
              SERVE_ALONE_ROWS), in one batch of 64 and through
              `EmbeddingServer` (the first 16, SERVE_CLIENT_ROWS)
              (8 client threads, padded buckets) within 1e-5 of the others
              (bit-equality printed), on both maps, and on 16 rows of the
              t-SNE map with exhaustive repulsion; the default engine solver's energies
              on 64 rows, exhaustive, finite and never increasing; one HTTP
              round trip to the CLI on localhost equal to the direct
              transform.  Printed: the CPU path's gap on the same rows
              (`device="cpu"`, exhaustive, 3 iterations), the share of
              queries nearest their own class's centroid, the server's
              latency percentiles, mean batch and rows/s over 512
              single-row requests from 8 threads, direct transforms of 1,
              64 and 1024 rows (ms, iterations, energy evaluations and
              device reads an iteration), the cross-kNN alone, and one
              64-row batch under torch.profiler (device busy, idle share).
              Then the same 512 requests through `EmbeddingServer(
              telemetry=<dir>)`: 512 request records with status ok, one
              serve/batch span for each batch of its `stats()`, and rows
              bit-equal to the server's without telemetry.
 22. lm_serve — the LM scaffolding's serving path (`repro_torch.configs`,
              `models`, `data.batch_for`, `launch/serve.py`), in a fresh
              process of its own.  The ten archs' smoke configs at float32
              compute on the card and the CPU, the same params and tokens:
              a prefill and four teacher-forced decode steps (each from the
              CPU's caches), float32 leaves within 1e-4 of the leaf's scale,
              bf16 leaves within one ulp of the leaf's largest value, ints
              exactly.  Then at full width,
              each at the depth one card holds with f32 master weights
              (printed): qwen2-7b (all 28 layers, 7.6 B params), rwkv6-7b
              (32), zamba2-2.7b (54), musicgen-medium (48),
              llama-3.2-vision-90b (one group of 5 layers) and grok-1-314b
              (1 layer, capacity_factor 8), params drawn on the card: the
              reference serve driver's loop (batch 4, prompt 32, 16 sampled
              tokens at temperature 1) twice, printing the warm prefill ms,
              decode p50 / p99 ms a step, tokens a second and peak memory;
              finite logits; four teacher-forced decode steps against a
              prefill over T + 4 within 5e-2 (qwen2-7b's gap also at depths
              1, 7, 28).  A warmed qwen2-7b decode step runs under
              `assert_compile_count(expected=0)` and
              `no_implicit_transfers()`, and qwen2-7b once more with its
              params cast to bf16 once (the reference's serve_param_dtype
              knob).  The LM path launches none of the five kernels: their
              counts in this process must not move, and the child's are 0.

Every phase runs, at full width; the script takes no options.  The line
before the last is a JSON record of every kernel; the last line is
`{"ok": true, "device": {...}}`.  Without CUDA the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent
N_FIT = 20000        # MNIST-20k, the paper's large configuration
KERNEL_SOURCES = ("pairwise", "ell", "farfield")   # csrc/<name>.cu

# NVIDIA H100 SXM data sheet (700 W): HBM3 rate, f32 rate outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# f32 operations a pair in the pairwise kernel at d = 2 (difference and
# square per dimension, kernel value, weights, six accumulations): counted
# from csrc/pairwise.cu, transcendental calls as one each
FLOPS_PER_PAIR = 25

# tolerances of tests/test_kernels_pairwise.py (the reference's own kernel
# test): la_x, lb_x at rtol 5e-5 with atol scaled by max|.|, scalars 1e-4.
# The atol here is 5e-5 max|want| without the reference test's "+ 1": on
# the fits' affinities la_x is far below 1, and an absolute floor of 5e-5
# would pass any la_x at all.
# The kernel is held against its plain version evaluated in float64 on the
# same (storage-rounded) inputs: in float32 the plain version's
# sum(a) x_n - sum(a x_m) loses digits to cancellation on a spread-out
# embedding, which the kernel's sum(a (x_n - x_m)) does not.
# On the fits' own data a row of L(w)X may cancel far below its terms, and
# a float32 sum is only good to its terms' magnitude: there the bound also
# has 5e-5 sum_m |w_nm (x_n - x_m)| per entry, above the worst-case
# rounding of the kernel's sums (N/32 terms a lane, 625 * 2^-24 = 3.7e-5
# at N = 20000), and a floor for what float32 cannot hold: each of a row's
# N terms may lose up to FLT_MIN (1 + w)(1 + |x_n - x_m|) where a weight
# such as exp(-t) falls below float32's smallest normal number (in the
# bfloat16-rounded t-SNE embedding, ssne's lb_x is ~1e-63 in float64).
# Every bound must reject an all-zero la_x and lb_x ("teeth"), except with
# bfloat16 storage of the fits' embeddings, whose rounding may merge
# neighbours and leave only cancellation noise or underflow.
TOL_LAP = 5e-5
TOL_SCALAR = 1e-4
EPAN_EDGE = 1e-5     # |t - 1| band of the epan slack (float32 t: ~1e-7)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rand_problem(n: int, d: int, seed: int, device) -> tuple:
    """X (n, d) and symmetric, zero-diagonal, positive Wa, Wb (n, n)."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, d), generator=g, device=device)
    Ws = []
    for _ in range(2):
        W = torch.randn((n, n), generator=g, device=device).abs_()
        W = 0.5 * (W + W.T)
        Ws.append(W.fill_diagonal_(0.0))
    return X, Ws[0], Ws[1]


def plain64(X, Wa, Wb, kind, storage, with_mass=False, chunk=2048):
    """The plain version in float64 on the storage-rounded inputs, the
    per-entry slack of lb_x at Epanechnikov's support edge and, with
    `with_mass`, the terms' magnitudes sum_m |w_nm (x_n - x_m)| of la_x
    (w = a) and lb_x (w = b), as {"la_x": ..., "lb_x": ...}.

    With `with_mass`, la_x and lb_x are also summed as sum_m w (x_n - x_m)
    in float64 and replace the oracle's (sum_m w) x_n - sum_m w x_m: on the
    t-SNE fit's embedding la_x is ~1e-9 in float32 (far less in bfloat16),
    and that form's float64 cancellation would exceed the bound.  The
    largest gap between the two forms is returned as mass["gap"], and the
    float32 underflow floor of the bound (see TOL_LAP) as mass["floor"].

    epan's b = Wb [t < 1] jumps at t = 1: a pair whose t lies within float32
    rounding of 1 can fall on either side in two correct float32
    evaluations, moving lb_x by Wb |x_n - x_m|.  The sum of that over the
    pairs with |t - 1| < EPAN_EDGE is the slack added to lb_x's bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import negative_pair_terms, pairwise_terms_ref
    X64, Wa64, Wb64 = (ops.to_storage(t, storage).double()
                       for t in (X, Wa, Wb))
    ref = pairwise_terms_ref(X64, Wa64, Wb64, kind)
    slack = torch.zeros_like(ref.lb_x)
    mass = ({"la_x": torch.zeros_like(ref.la_x),
             "lb_x": torch.zeros_like(ref.lb_x)} if with_mass else None)
    direct = {k: torch.zeros_like(v) for k, v in (mass or {}).items()}
    if kind != "epan" and not with_mass:
        return ref, slack, mass
    for r0 in range(0, X64.shape[0], chunk):   # (chunk, N) temporaries
        rows = slice(r0, r0 + chunk)
        signed = X64[rows, None, :] - X64[None, :, :]
        diff = signed.abs()
        t = torch.sum(signed * signed, dim=-1)
        if kind == "epan":
            near = ((t - 1.0).abs() < EPAN_EDGE) * Wb64[rows]
            slack[rows] = torch.einsum("cm,cmk->ck", near, diff)
        if with_mass:
            s_pair, b_pair = negative_pair_terms(kind, t)
            a = Wa64[rows] * s_pair if kind == "tsne" else Wa64[rows]
            b = Wb64[rows] * b_pair
            for name, w in (("la_x", a), ("lb_x", b)):
                mass[name][rows] = torch.einsum("cm,cmk->ck", w, diff)
                direct[name][rows] = torch.einsum("cm,cmk->ck", w, signed)
    if with_mass:
        mass["gap"] = max(float((getattr(ref, k) - direct[k]).abs().max())
                          for k in direct)
        ref = ref._replace(**direct)
        span = 1.0 + float(X64.max() - X64.min())
        mass["floor"] = {name: torch.finfo(torch.float32).tiny * X64.shape[0]
                         * (1.0 + float(W.abs().max())) * span
                         for name, W in (("la_x", Wa64), ("lb_x", Wb64))}
    return ref, slack, mass


def compare(terms, ref, slack, mass=None, teeth=True
            ) -> tuple[float, float, float, list]:
    """Max abs error of la_x/lb_x, max relative error of the scalars, the
    largest error-to-bound ratio of la_x/lb_x, and the names among la_x,
    lb_x whose bound an all-zero output would meet; raises when a tolerance
    is missed, or with `teeth` when a bound would pass zeros."""
    lap_err = ratio = 0.0
    toothless = []
    for name in ("la_x", "lb_x"):
        got, want = getattr(terms, name).double(), getattr(ref, name)
        err = (got - want).abs()
        tol = TOL_LAP * want.abs().max() + TOL_LAP * want.abs()
        if name == "lb_x":
            tol = tol + slack
        if mass is not None:
            tol = tol + TOL_LAP * mass[name] + mass["floor"][name]
        if not bool(torch.all(err <= tol)):
            raise AssertionError(f"{name}: max abs err {float(err.max()):.3e}")
        if bool(torch.all(want.abs() <= tol)):
            toothless.append(name)
            if teeth:
                raise AssertionError(f"{name}: the bound would pass an "
                                     f"all-zero output")
        lap_err = max(lap_err, float(err.max()))
        ratio = max(ratio, float((err / tol).max()))
    sc_err = 0.0
    for name in ("e_plus", "s"):
        got, want = float(getattr(terms, name)), float(getattr(ref, name))
        rel = abs(got - want) / max(abs(want), 1e-30)
        if rel > TOL_SCALAR:
            raise AssertionError(f"{name}: {got} vs {want} (rel {rel:.3e})")
        sc_err = max(sc_err, rel)
    return lap_err, sc_err, ratio, toothless


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Device time of one fn() call: `reps` calls captured in one CUDA graph
    and replayed, so that no host time (Python, ctypes, allocation) enters.
    Every kernel's time is taken so; `cuda_ms`'s back-to-back eager calls
    measure the host's issue rate for kernels of tens of microseconds, and
    time the plain versions and library calls, which are not captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture stream
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * reps)
    del graph
    return ms


def phase_probe() -> None:
    dev = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say("probe", f"torch {torch.__version__} cuda {torch.version.cuda} "
                 f"python {sys.version.split()[0]}")
    say("probe", f"device {dev} capability {cap[0]}.{cap[1]} "
                 f"count {torch.cuda.device_count()}")
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    say("probe", "nvcc " + nvcc.stdout.strip().splitlines()[-1])
    say("probe", f"nvidia-smi {smi()}")


def phase_build() -> None:
    """Build every kernel source (one nvcc each, all started together)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    for name in KERNEL_SOURCES:
        _build.load(name)
    for name in KERNEL_SOURCES:
        info = _build.BUILD_INFO[name]
        regs = [int(line.split("Used ")[1].split(" registers")[0])
                for line in info["log"].splitlines() if "registers" in line]
        spills = [line.strip() for line in info["log"].splitlines()
                  if "spill" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        say("build", f"{name}.cu built in {info['seconds']:.1f} s; "
                     f"{len(regs)} kernels, registers max "
                     f"{max(regs, default=0)}, kernels spilling {len(spills)}")
    say("build", f"all sources loaded {time.perf_counter() - t0:.1f} s after "
                 f"the build started")


def phase_check() -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.pairwise import pairwise_terms_cuda
    from repro_torch.kernels.ref import KINDS
    # N = 1000 fits one column tile (1024); 4096 is several tiles with
    # 16-byte aligned rows, the vectorized path the main path runs; 4097 is
    # ragged and runs the scalar path
    cases = [(n, d) for n in (1000, 4096, 4097) for d in (2, 3)]
    cases += [(1000, 1), (1000, 4), (1000, 6), (4097, 5)]
    worst_ratio = worst_sc = 0.0
    n_ok = 0
    for n, d in cases:
        X, Wa, Wb = rand_problem(n, d, seed=n * 10 + d, device="cuda")
        for storage in ("float32", "bfloat16"):
            Xs, Was, Wbs = (ops.to_storage(t, storage) for t in (X, Wa, Wb))
            for kind in KINDS:
                ref, slack, _ = plain64(X, Wa, Wb, kind, storage)
                got = pairwise_terms_cuda(Xs, Was, Wbs, kind)
                torch.cuda.synchronize()
                try:
                    _, sc, ratio, _ = compare(got, ref, slack)
                except AssertionError as e:
                    raise AssertionError(
                        f"kernel != plain at n={n} d={d} {storage} {kind}: "
                        f"{e}") from None
                again = pairwise_terms_cuda(Xs, Was, Wbs, kind)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"rerun not bit-identical at n={n} "
                                         f"d={d} {storage} {kind}")
                worst_ratio = max(worst_ratio, ratio)
                worst_sc = max(worst_sc, sc)
                n_ok += 1
    say("check", f"{n_ok} cases (kinds x f32/bf16 x (N, d) in {cases}) "
                 f"match the float64 plain version, reruns bit-identical; worst "
                 f"la/lb error at {worst_ratio:.2f} of its bound, worst "
                 f"scalar rel err {worst_sc:.3e}")


def phase_fit(n: int = N_FIT, iters: int = 10) -> dict:
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.data import mnist_like
    from repro_torch.kernels import pairwise

    t0 = time.perf_counter()
    Y, _ = mnist_like(n=n, dim=784, seed=0)
    say("fit", f"mnist_like(n={n}, dim=784) made in "
               f"{time.perf_counter() - t0:.1f} s")
    configs = [
        ("ee", EmbedSpec(kind="ee", lam=100.0, perplexity=30.0,
                         backend="dense", strategy="sd",
                         strategy_opts={"kappa": 7}, max_iters=iters,
                         tol=0.0)),
        ("tsne", EmbedSpec(kind="tsne", lam=1.0, perplexity=30.0,
                           backend="dense", strategy="sd",
                           strategy_opts={"kappa": -1}, max_iters=iters,
                           tol=0.0)),
    ]
    launches = 0
    data = {}
    starts = {}
    emb = None
    for kind, spec in configs:
        emb = None            # free the previous fit's N x N state first
        torch.cuda.empty_cache()
        pairwise.reset_launch_counts()
        t0 = time.perf_counter()
        emb = Embedding(spec).fit(Y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fit_launches = pairwise.launch_counts["pairwise_terms"]
        res = emb.result_
        e = res.energies
        if not np.all(np.isfinite(e)):
            raise AssertionError(f"{kind}: non-finite energies {e}")
        if np.any(np.diff(e) > 0):
            raise AssertionError(f"{kind}: energy increased: {e}")
        if fit_launches < 1 or fit_launches != int(res.n_fevals[-1]):
            raise AssertionError(
                f"{kind}: {fit_launches} kernel launches for "
                f"{int(res.n_fevals[-1])} energy evaluations")
        X = emb.embedding_
        if tuple(X.shape) != (n, 2) or not bool(torch.isfinite(X).all()):
            raise AssertionError(f"{kind}: bad embedding {tuple(X.shape)}")
        launches += fit_launches
        pt = res.phase_times
        per_it = res.times[-1] / res.n_iters
        say("fit", f"{kind}: N={n} setup affinities {pt['affinities_s']:.2f} s"
                   f", spectral init (eigh) {pt['spectral_init_s']:.2f} s, "
                   f"SD init (B + Cholesky) {res.setup_time:.2f} s; "
                   f"{res.n_iters} iterations at {per_it * 1e3:.1f} ms each; "
                   f"kernel launches {fit_launches} (= energy evaluations: 1 "
                   f"initial + {(fit_launches - 1) / res.n_iters:.2f} per "
                   f"iteration); wall {wall:.1f} s")
        say("fit", f"{kind}: energies {np.array2string(e, precision=8)}")
        # the same fit through the plain PyTorch path, same start
        pairwise.reset_launch_counts()
        plain = Embedding(spec.replace(kernel_impl="torch", max_iters=3)).fit(
            None, X0=emb.X0_, aff=emb.affinities_)
        if pairwise.launch_counts["pairwise_terms"]:
            raise AssertionError(f"{kind}: the plain path launched the "
                                 f"kernel: {dict(pairwise.launch_counts)}")
        ep = plain.result_.energies
        rel = np.max(np.abs(ep - e[:4]) / np.abs(e[:4]))
        if rel > 1e-4:
            raise AssertionError(f"{kind}: kernel path {e[:4]} vs plain path "
                                 f"{ep} (rel {rel:.2e})")
        say("fit", f"{kind}: first 3 iterations match the plain path, max "
                   f"rel diff {rel:.2e}")
        del plain
        if kind == "ee":
            # the serving phase's exact-kNN case loads this artifact
            emb.save(str(SERVE_DIR / "ee_dense.npz"))
            # phase resume holds its resumed fit to this one
            resume_ref = {"spec": spec, "Y": Y, "X0": emb.X0_,
                          "energies": e, "X": X.cpu()}
        data[kind] = (X, emb.affinities_.Wp, emb.affinities_.Wm)
        starts[kind] = (emb.X0_, emb.affinities_)
    emb.result_.state = None    # the timing phase needs X and aff only
    return {"launches": launches, "emb": emb, "data": data,
            "starts": starts, "settled": {"ee": data["ee"][0]},
            "resume_ref": resume_ref}


def phase_time(data: dict) -> dict:
    """The kernel beside its bound and its plain version, for every kind and
    both storage dtypes, each call held against the plain version.  A kind
    runs on the embedding and affinities of the fit that shares its
    normalization: EE's for ee, tee and epan, t-SNE's for ssne and tsne."""
    from repro_torch.core.objectives import is_normalized
    from repro_torch.kernels import ops
    from repro_torch.kernels.pairwise import pairwise_terms_cuda
    from repro_torch.kernels.ref import KINDS

    n, d = data["ee"][0].shape
    out = {}
    for storage, size in (("float32", 4), ("bfloat16", 2)):
        stored = {fit: tuple(ops.to_storage(t, storage) for t in tensors)
                  for fit, tensors in data.items()}
        nbytes = 2 * n * n * size + n * d * size + 2 * n * d * 4 + 8
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = FLOPS_PER_PAIR * n * n / PEAK_F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        say("time", f"N={n} d={d} {storage}: bound {bound_ms:.3f} ms "
                    f"({nbytes / 1e9:.2f} GB at 3.35 TB/s; operations "
                    f"{t_ops:.3f} ms at 67 TFLOP/s); errors against the "
                    f"float64 plain version; no single PyTorch call computes "
                    f"this function, so library_ms is null")
        for kind in KINDS:
            fit = "tsne" if is_normalized(kind) else "ee"
            X, Wa, Wb = data[fit]
            Xs, Was, Wbs = stored[fit]
            def call():
                return pairwise_terms_cuda(Xs, Was, Wbs, kind)
            ms = graph_ms(call, reps=20)
            eager_ms = cuda_ms(call, reps=20)
            plain_ms = cuda_ms(lambda: ops.pairwise_terms(
                Xs, Was, Wbs, kind, impl="torch"), reps=3, warmup=1)
            got = pairwise_terms_cuda(Xs, Was, Wbs, kind)
            ref, slack, mass = plain64(X, Wa, Wb, kind, storage,
                                       with_mass=True)
            try:
                lap_err, sc_err, ratio, toothless = compare(
                    got, ref, slack, mass, teeth=storage == "float32")
            except AssertionError as e:
                raise AssertionError(f"kernel != plain at N={n} {storage} "
                                     f"{kind} on the {fit} fit: {e}") from None
            sizes = "/".join(f"{float(getattr(ref, k).abs().max()):.2e}"
                             for k in ("la_x", "lb_x"))
            plain = ops.pairwise_terms(Xs, Was, Wbs, kind, impl="torch")
            plain_err = max(float((getattr(plain, k).double()
                                   - getattr(ref, k)).abs().max())
                            for k in ("la_x", "lb_x"))
            mass_gap = mass["gap"]
            del got, ref, slack, mass, plain
            out[kind, storage] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "max_abs_err": lap_err}
            say("time", f"  {kind:4s} {storage} on the {fit} fit: kernel "
                        f"{ms:.3f} ms on the device "
                        f"({t_bytes / ms * 100:.0f}% of the memory bound; "
                        f"{eager_ms:.3f} ms a call issued eagerly), "
                        f"plain {plain_ms:.3f} ms; la/lb max abs err "
                        f"{lap_err:.3e}, at {ratio:.2f} of its bound "
                        f"(max |la_x|/|lb_x| {sizes}; plain float32 err "
                        f"{plain_err:.3e}), scalar rel err {sc_err:.2e}; "
                        f"bounds that would pass zeros: "
                        f"{'/'.join(toothless) or 'none'}; float64 oracle "
                        f"forms differ by {mass_gap:.1e}")
    return out


def phase_profile(emb, iters: int = 3) -> None:
    """Where an SD iteration's time goes: `iters` fused steps of the last
    fit, continued from its embedding, under torch.profiler.  Prints the
    device time by kernel and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api.registries import strategy_entry
    from repro_torch.core.minimize import DenseObjective

    spec, X = emb.spec, emb.embedding_
    obj = DenseObjective(
        emb.affinities_, spec.kind, torch.tensor(spec.lam, device=X.device),
        strategy_entry(spec.strategy).dense_factory(
            spec, **dict(spec.strategy_opts)),
        spec.resolved_ls(), X)
    _, state = obj.make_direction_solver()
    step = obj.make_fused_step()
    E, G = obj.energy_and_grad(X, None)
    alpha = torch.ones((), device=X.device)
    X, E, G, state, alpha, _ = step(X, E, G, state, alpha)   # warm-up
    torch.cuda.synchronize()
    n_evals = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            X, E, G, state, alpha, ne = step(X, E, G, state, alpha)
            n_evals += ne
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: an aten op's device time is its kernels'
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        say("profile", "torch.profiler recorded no device kernels: device "
                       "time and idle share not measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    say("profile", f"{spec.kind} N={X.shape[0]}: {iters} SD iterations "
                   f"({n_evals} energy evaluations) in {wall * 1e3:.1f} ms "
                   f"wall; device busy {busy * 1e3:.1f} ms, idle share "
                   f"{max(0.0, 1 - busy / wall):.2f}")
    for dev_us, key, count in rows[:8]:
        say("profile", f"  {dev_us / 1e3 / iters:8.3f} ms/iteration "
                       f"{count // iters:3d} calls/iteration  {key[:90]}")


# -- the paper's dense lineup and the homotopy path ----------------------------

LINEUP = ("diag", "cg", "lbfgs", "sd-")      # GD, FP and SD run elsewhere
LINEUP_LAMS = {"ee": 100.0, "tsne": 1.0}
LINEUP_ITERS = 5
LINEUP_CHECK_ITERS = 3
# On EE from the spectral start DiagH and nonlinear CG take gradient-descent
# steps: DiagH's Hessian diagonal is negative there, so every entry sits at
# its floor and the direction is -G scaled, and CG's beta is about 0.  The
# third such step amplifies float32 rounding about a thousandfold, as GD's
# does (ROADMAP.md, Queue 3): the kernel path, the plain path and the plain
# path in float64 part from each other by 3e-3 to 1e-2 there.  So on EE they
# are held from phase fit's settled embedding (ten SD iterations), where
# they are not GD, at the lambda given here, against the plain path and
# against the plain path in float64.  DiagH is held at lambda = 1: at 100
# and 10 its diagonal has entries within float32 rounding of zero, whose
# quotients part both float32 paths from float64 by 7e-5 to 3e-4 in three
# iterations (lineup_witness.py prints every case).
# At the spectral start the plain path must itself be more than 1e-4 off
# float64 wherever the kernel path is more than 1e-4 off the plain path.
SETTLED_HOLD = {"diag": 1.0, "cg": 100.0}
# SD- on EE grows the kernel's float32 gradient rounding at the spectral
# start (2.5e-6 of max |G| there) to ~1e-4 by the third iteration at
# lambda = 100, and is held at lambda = 1
EE_HOLD_LAM = {"sd-": 1.0}


def _rel_trace_gap(a, b) -> float:
    n = min(len(a), len(b))
    return float(np.max(np.abs(np.asarray(a[:n]) - np.asarray(b[:n]))
                        / np.abs(np.asarray(b[:n]))))


def _lineup_fit(spec, X0, aff) -> tuple:
    """One kernel-path fit from the given start: the result, the pairwise
    launches of the fit, its wall seconds and its peak device memory."""
    from repro_torch.api import Embedding
    from repro_torch.kernels import pairwise
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pairwise.reset_launch_counts()
    t0 = time.perf_counter()
    res = Embedding(spec).fit(None, X0=X0, aff=aff).result_
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, pairwise.launch_counts["pairwise_terms"], wall,
            torch.cuda.max_memory_allocated())


def _plain_energies(spec, X0, aff, iters: int = LINEUP_CHECK_ITERS):
    """The energies of `spec`'s first `iters` iterations from X0 on the
    plain path, which must launch nothing."""
    from repro_torch.api import Embedding
    from repro_torch.kernels import pairwise
    pairwise.reset_launch_counts()
    plain = Embedding(spec.replace(kernel_impl="torch", max_iters=iters)).fit(
        None, X0=X0, aff=aff).result_
    if pairwise.launch_counts["pairwise_terms"]:
        raise AssertionError(f"{spec.strategy} {spec.kind}: the plain path "
                             f"launched the kernel")
    return plain.energies


def _plain64_energies(spec, X0, aff, iters: int = LINEUP_CHECK_ITERS):
    """The same as `_plain_energies` in float64: the dense backend's
    strategy, line search and loop from X0 and the affinities widened, with
    the plain version's pairwise terms computed in float64 (the
    dispatcher's plain branch computes in float32, so this run swaps in the
    plain version itself)."""
    from unittest import mock

    from repro_torch.api.registries import strategy_entry
    from repro_torch.core.affinities import Affinities
    from repro_torch.core.minimize import DenseObjective
    from repro_torch.embed.engine import fit_loop, make_loop_config
    from repro_torch.kernels import ops, pairwise
    from repro_torch.kernels.ref import pairwise_terms_ref

    def terms64(X, Wa, Wb, kind, **_):
        return pairwise_terms_ref(X, Wa.double(), Wb.double(), kind)

    spec = spec.replace(kernel_impl="torch", max_iters=iters)
    X0 = X0.double()
    aff = Affinities(aff.Wp.double(), aff.Wm.double())
    ls = spec.resolved_ls()
    strategy = strategy_entry(spec.strategy).dense_factory(
        spec, **dict(spec.strategy_opts))
    pairwise.reset_launch_counts()
    with mock.patch.object(ops, "pairwise_terms", terms64):
        obj = DenseObjective(aff, spec.kind,
                             torch.tensor(spec.lam, dtype=X0.dtype,
                                          device=X0.device),
                             strategy, ls, X0, impl=spec.kernel_args())
        res = fit_loop(obj, X0, make_loop_config(spec, ls))
    if pairwise.launch_counts["pairwise_terms"]:
        raise AssertionError(f"{spec.strategy} {spec.kind}: the float64 "
                             f"plain path launched the kernel")
    return res.energies


def _check_descent(tag: str, e) -> None:
    if not np.all(np.isfinite(e)):
        raise AssertionError(f"{tag}: non-finite energies {e}")
    if np.any(np.diff(e) > 0):
        raise AssertionError(f"{tag}: energy increased: {e}")


def _diag_above_floor(X, aff, kind, lam) -> tuple[int, int]:
    """How many entries of DiagH's Hessian diagonal at X lie above its
    floor (those whose direction is not -G scaled), and how many there
    are."""
    from repro_torch.core import DiagH
    from repro_torch.core.hessians import diag_hessian
    d = diag_hessian(X, aff, kind, torch.tensor(lam, device=X.device))
    floor = DiagH.floor_scale * torch.clamp_min(d.abs().max(), 1e-30)
    return int((d > floor).sum()), d.numel()


def phase_fit_lineup(starts: dict, settled: dict) -> dict:
    """The rest of the paper's dense lineup at N = 20000 from phase fit's
    affinities and spectral starts: DiagH, nonlinear CG, L-BFGS and SD-
    through `Embedding(EmbedSpec(backend="dense", strategy=...))`, EE at
    lambda = 100 and t-SNE at lambda = 1, five iterations each; then
    SparseSD (k = 7) through `_minimize` and `homotopy_path` with SD, both
    on the EE problem.  `settled` holds phase fit's EE embedding after its
    ten SD iterations, where SETTLED_HOLD's methods are held.  Each held
    trace must also part from GD's from the same start by more than the
    tolerance, so that the check sees the method and not GD: on EE a
    failure, on t-SNE (where CG and L-BFGS reduce to GD from the spectral
    start) a line that says only the -G path was checked.  Returns the
    pairwise and ELL launches of these main paths and each fit's
    numbers."""
    from repro_torch.api import EmbedSpec
    from repro_torch.core import SD, LSConfig, homotopy_path, make_strategy
    from repro_torch.core.minimize import _minimize
    from repro_torch.core.objectives import energy_and_grad
    from repro_torch.kernels import pairwise, sparse_attractive
    from repro_torch.sparse.graph import NeighborGraph
    from repro_torch.sparse.linalg import pcg, sym_lap_matvec

    t_phase = time.perf_counter()
    launches = 0
    rows = {}
    failed = []
    gd_traces = {}

    def gd_energies(spec, X, aff, where):
        """GD's kernel-path energies over the held iterations (a comparison
        run: its launches stay apart)."""
        key = (spec.kind, spec.lam, where)
        if key not in gd_traces:
            gd_traces[key] = _lineup_fit(
                spec.replace(strategy="gd", max_iters=LINEUP_CHECK_ITERS),
                X, aff)[0].energies
        return gd_traces[key]

    for kind, lam in LINEUP_LAMS.items():
        X0, aff = starts[kind]
        resident = torch.cuda.memory_allocated()
        for strategy in LINEUP:
            spec = EmbedSpec(kind=kind, lam=lam, perplexity=30.0,
                             backend="dense", strategy=strategy,
                             max_iters=LINEUP_ITERS, tol=0.0)
            tag = f"{strategy} {kind}"
            res, n_launch, wall, peak = _lineup_fit(spec, X0, aff)
            e = res.energies
            _check_descent(tag, e)
            if n_launch < 1 or n_launch != int(res.n_fevals[-1]):
                raise AssertionError(
                    f"{tag}: {n_launch} kernel launches for "
                    f"{int(res.n_fevals[-1])} energy evaluations")
            launches += n_launch
            pairs = (int(res.state["count"]) if strategy == "lbfgs"
                     else None)
            res.state = None
            # what the check holds (comparison runs: their launches stay
            # apart): the spec, its start and the kernel path's energies
            notes = []
            held_spec, held_X, held_e = spec, X0, e
            where = "the spectral start"
            if kind == "ee" and strategy in SETTLED_HOLD:
                plain_e = _plain_energies(spec, X0, aff)
                spectral_gap = _rel_trace_gap(e, plain_e)
                own64 = _rel_trace_gap(plain_e,
                                       _plain64_energies(spec, X0, aff))
                if spectral_gap > 1e-4 and own64 <= 1e-4:
                    failed.append(
                        f"{tag}: at the spectral start the kernel path "
                        f"parts from the plain path by {spectral_gap:.2e} "
                        f"while the plain path tracks float64 ({own64:.2e})")
                notes.append(
                    f"at the spectral start the kernel path parts from the "
                    f"plain path by {spectral_gap:.2e}, the plain path from "
                    f"float64 by {own64:.2e}")
                held_X, where = settled[kind], "phase fit's settled embedding"
                held_spec = spec.replace(lam=SETTLED_HOLD[strategy],
                                         max_iters=LINEUP_CHECK_ITERS)
                held_e = _lineup_fit(held_spec, held_X, aff)[0].energies
                _check_descent(f"{tag} (held)", held_e)
                gap64 = _rel_trace_gap(
                    held_e, _plain64_energies(held_spec, held_X, aff))
                if gap64 > 1e-4:
                    failed.append(f"{tag}: kernel path vs the float64 plain "
                                  f"path from {where} rel {gap64:.2e}")
                notes.append(f"held, the kernel path is {gap64:.2e} from "
                             f"the float64 plain path")
            elif kind == "ee" and strategy in EE_HOLD_LAM:
                amplified = _rel_trace_gap(e, _plain_energies(spec, X0, aff))
                notes.append(f"at lambda = {lam:g} the kernel path parts "
                             f"from the plain path by {amplified:.2e}")
                held_spec = spec.replace(lam=EE_HOLD_LAM[strategy],
                                         max_iters=LINEUP_CHECK_ITERS)
                held_e = _lineup_fit(held_spec, X0, aff)[0].energies
            gap = _rel_trace_gap(held_e, _plain_energies(held_spec, held_X,
                                                         aff))
            held = (f"first {LINEUP_CHECK_ITERS} iterations from {where} "
                    f"match the plain path at lambda = {held_spec.lam:g}")
            if gap > 1e-4:
                failed.append(f"{tag}: kernel path vs plain path rel "
                              f"{gap:.2e} ({held})")
            # the held trace must be the method's, not GD's
            apart = _rel_trace_gap(held_e[:LINEUP_CHECK_ITERS + 1],
                                   gd_energies(held_spec, held_X, aff, where))
            if strategy == "diag":
                above, total = _diag_above_floor(held_X, aff, kind,
                                                 held_spec.lam)
                if held_X is not X0:
                    above = (f"{_diag_above_floor(X0, aff, kind, lam)[0]} "
                             f"at the spectral start, {above} at the held one")
                notes.append(f"diagonal entries above the floor (of "
                             f"{total}): {above}")
            if strategy == "lbfgs":
                notes.append(f"{pairs} (s, y) pairs stored over the fit")
            notes.append(f"GD's trace from there is {apart:.2e} away")
            if apart <= 1e-4 or pairs == 0:
                if kind == "ee":
                    failed.append(f"{tag}: the held trace is GD's within "
                                  f"{apart:.2e}" + (" and L-BFGS stored no "
                                                    "pair" if pairs == 0
                                                    else ""))
                notes.append("it reduces to GD there: only the -G path is "
                             "checked")
            per_it = res.times[-1] / res.n_iters
            rows[strategy, kind] = {
                "setup_s": res.setup_time, "ms_per_iter": per_it * 1e3,
                "fevals_per_iter": (res.n_fevals[-1] - 1) / res.n_iters,
                "peak_gb": peak / 1e9, "resident_gb": resident / 1e9}
            say("lineup", f"{tag}: N={X0.shape[0]} lambda={lam:g} set-up "
                          f"(strategy.init) {res.setup_time:.3f} s; "
                          f"{res.n_iters} iterations at {per_it * 1e3:.1f} "
                          f"ms each, {rows[strategy, kind]['fevals_per_iter']:.2f}"
                          f" energy evaluations each (kernel launches "
                          f"{n_launch} = evaluations); peak device memory "
                          f"{peak / 1e9:.2f} GB (affinities resident "
                          f"{resident / 1e9:.2f} GB); wall {wall:.1f} s; "
                          f"energies {np.array2string(e, precision=8)}; "
                          f"{held}: max rel diff {gap:.2e} ("
                          + "; ".join(notes) + ")")
            del res
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))

    # SparseSD on the EE problem (the paper's kappa = 7 on MNIST-20k)
    X0, aff = starts["ee"]
    lam = LINEUP_LAMS["ee"]
    strategy = make_strategy("sparsesd", k=7)
    ls = LSConfig(init_step="adaptive_grow")
    torch.cuda.synchronize()
    pairwise.reset_launch_counts()
    sparse_attractive.reset_launch_counts()
    t0 = time.perf_counter()
    res = _minimize(X0, aff, "ee", lam, strategy, max_iters=LINEUP_ITERS,
                    tol=0.0, ls_cfg=ls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ell_launches = dict(sparse_attractive.launch_counts)
    n_launch = pairwise.launch_counts["pairwise_terms"]
    _check_descent("sparsesd ee", res.energies)
    if n_launch != int(res.n_fevals[-1]):
        raise AssertionError(f"sparsesd ee: {n_launch} pairwise launches "
                             f"for {int(res.n_fevals[-1])} evaluations")
    if ell_launches["ell_lap_matvec_vmem"] < 1 or any(
            v for k, v in ell_launches.items()
            if k != "ell_lap_matvec_vmem"):
        raise AssertionError(f"sparsesd ee: ELL launches {ell_launches}")
    launches += n_launch
    state = res.strategy_state
    say("lineup", f"sparsesd ee: k=7 (graph {tuple(state['indices'].shape)}"
                  f", reverse {tuple(state['rev_indices'].shape)}) set-up "
                  f"{res.setup_time:.3f} s; {res.n_iters} iterations at "
                  f"{res.times[-1] / res.n_iters * 1e3:.1f} ms each, "
                  f"{(res.n_fevals[-1] - 1) / res.n_iters:.2f} evaluations "
                  f"each; ELL vmem launches "
                  f"{ell_launches['ell_lap_matvec_vmem']}; wall {wall:.1f} s;"
                  f" energies {np.array2string(res.energies, precision=8)}")
    # one direction from the kernel path against the same PCG solve on the
    # plain ELL product, from the same state and G
    X = res.X
    _, G = energy_and_grad(X, aff, "ee", torch.tensor(lam, device=X.device))
    P_kernel, _ = strategy.direction(state, X, G, aff, "ee", lam)
    g = NeighborGraph(state["indices"], state["weights"])
    rev = NeighborGraph(state["rev_indices"], state["rev_weights"])
    shift = state["shift"]
    P_plain = pcg(lambda V: 4.0 * sym_lap_matvec(g, V, rev=rev, impl="torch")
                  + shift[:, None] * V, -G, state["prev_P"],
                  inv_diag=state["inv_diag"], tol=strategy.cg_tol,
                  maxiter=strategy.cg_maxiter).x
    dir_gap = float((P_kernel - P_plain).abs().max() / P_plain.abs().max())
    if dir_gap > 1e-4:
        raise AssertionError(f"sparsesd: kernel-path direction vs plain "
                             f"ELL path: max rel {dir_gap:.2e}")
    say("lineup", f"sparsesd ee: one direction on the kernel path matches "
                  f"the plain ELL path's PCG solve, max |diff| / max |P| "
                  f"{dir_gap:.2e}")
    rows["sparsesd", "ee"] = {
        "setup_s": res.setup_time,
        "ms_per_iter": res.times[-1] / res.n_iters * 1e3,
        "fevals_per_iter": (res.n_fevals[-1] - 1) / res.n_iters}
    del res, state, P_kernel, P_plain, g, rev

    # homotopy_path with SD to lambda = 100 over 3 log-spaced stages
    pairwise.reset_launch_counts()
    t0 = time.perf_counter()
    hres = homotopy_path(X0, aff, "ee", SD(), lam_final=lam, n_stages=3,
                         max_iters=3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = pairwise.launch_counts["pairwise_terms"]
    for stage, r in zip(hres.lambdas, hres.results):
        _check_descent(f"homotopy stage lambda={stage:g}", r.energies)
        if r.energies[-1] >= r.energies[0]:
            raise AssertionError(f"homotopy stage lambda={stage:g} did not "
                                 f"descend: {r.energies}")
    if n_launch != int(np.sum(hres.fevals_per_lambda)):
        raise AssertionError(f"homotopy: {n_launch} pairwise launches for "
                             f"{hres.fevals_per_lambda} evaluations")
    launches += n_launch
    stages = "; ".join(
        f"lambda={lm:.3g}: {it} iterations, {fe} evaluations, {t:.2f} s "
        f"(set-up {r.setup_time:.2f} s), E {r.energies[0]:.6g} -> "
        f"{r.energies[-1]:.6g}"
        for lm, it, fe, t, r in zip(hres.lambdas, hres.iters_per_lambda,
                                    hres.fevals_per_lambda,
                                    hres.time_per_lambda, hres.results))
    say("lineup", f"homotopy_path sd ee: {stages}; wall {wall:.1f} s")
    del hres
    torch.cuda.empty_cache()
    say("lineup", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches,
            "ell_launches": ell_launches["ell_lap_matvec_vmem"],
            "rows": rows}


# -- slice 2: the sparse backend and the ELL kernels -------------------------

N_SPARSE = 70000     # the full MNIST set; backend="auto" resolves to sparse
ELL_LAYOUTS = ("vmem", "hbm")


def ell_problem(n: int, k: int, d: int, seed: int, device) -> tuple:
    """X (n, d), an ELL graph idx (n, k) int32 and weights (n, k) >= 0 with
    the cases the contract names: every 7th slot a padding slot (self, 0),
    rows 3 and 4 all padding, row 5 one column repeated, and self loops
    (the row's own index with a non-zero weight) at every 11th slot from 2
    and in every slot of row 6."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, d), generator=g, device=device)
    idx = torch.randint(0, n, (n, k), generator=g, device=device,
                        dtype=torch.int32)
    w = torch.randn((n, k), generator=g, device=device).abs_()
    rows = torch.arange(n, device=device, dtype=torch.int32)[:, None]
    pad = torch.zeros((n, k), dtype=torch.bool, device=device)
    pad[:, 3::7] = True
    pad[3:5] = True
    loop = torch.zeros_like(pad)
    loop[:, 2::11] = True
    loop[6] = True
    idx = torch.where(pad | loop, rows, idx)
    w = torch.where(pad, 0.0, torch.where(loop, w + 0.5, w))
    idx[5] = (5 + 1) % n
    return X, idx, w


def ell_plain64(X, idx, w, storage):
    """The plain version in float64 on the storage-rounded inputs."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ell_lap_matvec_ref
    return ell_lap_matvec_ref(ops.to_storage(X, storage).double(), idx,
                              ops.to_storage(w, storage).double())


def ell_compare(got, want, mass=None) -> tuple[float, float]:
    """Max abs error and its largest ratio to the bound.  The bound is that
    of tests/test_sparse_kernel.py (rtol 5e-5, atol 5e-5 max|want|) without
    the reference test's "+ 1" floor; on the fits' graphs (`mass` given) it
    adds 5e-5 sum_j |w_nj| (|x_n| + |x_m|), above the worst-case float32
    rounding of a k <= 400 term sum (400 * 2^-24 = 2.4e-5).  Raises when the
    error exceeds the bound or when the bound would pass an all-zero
    output."""
    err = (got.double() - want).abs()
    tol = TOL_LAP * want.abs().max() + TOL_LAP * want.abs()
    if mass is not None:
        tol = tol + TOL_LAP * mass
    if not bool(torch.all(err <= tol)):
        raise AssertionError(f"max abs err {float(err.max()):.3e}")
    if bool(torch.all(want.abs() <= tol)):
        raise AssertionError("the bound would pass an all-zero output")
    return float(err.max()), float((err / tol).max())


def phase_check_ell() -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_cuda
    n_ok = 0
    worst = 0.0
    for n in (1000, 4096, 4097):
        for k in (1, 24, 40, 90, 229, 386):
            for d in (1, 2, 3, 4, 8):
                X, idx, w = ell_problem(n, k, d, seed=n + 7 * k + d,
                                        device="cuda")
                for storage in ("float32", "bfloat16"):
                    Xs, ws = ops.to_storage(X, storage), ops.to_storage(
                        w, storage)
                    want = ell_plain64(X, idx, w, storage)
                    outs = {}
                    for layout in ELL_LAYOUTS:
                        got = ell_lap_matvec_cuda(Xs, idx, ws, layout=layout)
                        torch.cuda.synchronize()
                        outs[layout] = got
                        case = f"n={n} k={k} d={d} {storage} {layout}"
                        try:
                            _, ratio = ell_compare(got, want)
                        except AssertionError as e:
                            raise AssertionError(
                                f"ELL kernel != plain at {case}: {e}") from None
                        if not bool(torch.all(got[3:5] == 0)):
                            raise AssertionError(f"all-padding rows not 0 at "
                                                 f"{case}")
                        again = ell_lap_matvec_cuda(Xs, idx, ws,
                                                    layout=layout)
                        if not torch.equal(got, again):
                            raise AssertionError(f"rerun not bit-identical "
                                                 f"at {case}")
                        worst = max(worst, ratio)
                        n_ok += 1
                    if not torch.equal(outs["hbm"], outs["vmem"]):
                        raise AssertionError(
                            f"staged != direct gather at n={n} k={k} d={d} "
                            f"{storage}: max diff {float((outs['hbm'] - outs['vmem']).abs().max()):.3e}")
    say("check", f"ELL: {n_ok} cases (N in 1000/4096/4097 x k in "
                 f"1/24/40/90/229/386 x d in 1/2/3/4/8 x f32/bf16 x "
                 f"vmem/hbm, with "
                 f"padding slots, all-padding rows and a repeated column) "
                 f"match the float64 plain version, reruns bit-identical, "
                 f"padding rows exactly 0, the staged gather (hbm) equal to "
                 f"the direct gather (vmem) bit for bit; worst error at "
                 f"{worst:.2f} of its bound")


def _graph_stats(g) -> str:
    pad = float((g.weights == 0).float().mean())
    return f"width {g.k}, padded share {pad:.3f}"


def phase_fit_sparse(n: int = N_SPARSE, iters: int = 10) -> dict:
    """The slice-2 main path: `Embedding(EmbedSpec(kind=..., strategy="sd"))`
    with the default backend="auto" on N = 70000 points."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.data import mnist_like
    from repro_torch.embed.engine import fit_loop, make_loop_config
    from repro_torch.embed.trainer import build_sparse_objective
    from repro_torch.kernels import ops, sparse_attractive

    t0 = time.perf_counter()
    Y, labels = mnist_like(n=n, dim=784, seed=0)
    say("fit_sparse", f"mnist_like(n={n}, dim=784) made in "
                      f"{time.perf_counter() - t0:.1f} s")
    configs = [
        ("ee", EmbedSpec(kind="ee", lam=100.0, perplexity=30.0,
                         strategy="sd", n_negatives=5, max_iters=iters,
                         tol=0.0)),
        ("tsne", EmbedSpec(kind="tsne", lam=1.0, perplexity=30.0,
                           strategy="sd", n_negatives=5, max_iters=iters,
                           tol=0.0)),
    ]
    default = ops.ELL_DEFAULT_LAYOUT
    other, = (lay for lay in ELL_LAYOUTS if lay != default)
    out = {"launches": {default: 0}, "fits": {}, "Y": Y, "labels": labels,
           "default": default, "other": other}
    for kind, spec in configs:
        sparse_attractive.reset_launch_counts()
        diags = []
        t0 = time.perf_counter()
        emb = Embedding(spec).fit(Y, callback=lambda it, X, e, dg:
                                  diags.append(dg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sparse_attractive.launch_counts)
        if emb.backend_ != "sparse":
            raise AssertionError(f"{kind}: backend='auto' resolved to "
                                 f"{emb.backend_!r} at N={n}")
        if (counts[f"ell_lap_matvec_{default}"] < 1
                or counts[f"ell_lap_matvec_{other}"]):
            raise AssertionError(f"{kind}: the default fit's ELL launches "
                                 f"{counts} ({default} only, at least one)")
        out["launches"][default] += counts[f"ell_lap_matvec_{default}"]
        res = emb.result_
        e = res.energies
        if not np.all(np.isfinite(e)):
            raise AssertionError(f"{kind}: non-finite energies {e}")
        if not e[-1] < e[0]:
            raise AssertionError(f"{kind}: last surrogate energy {e[-1]} is "
                                 f"not below the first {e[0]}")
        X = emb.embedding_
        if tuple(X.shape) != (n, 2) or not bool(torch.isfinite(X).all()):
            raise AssertionError(f"{kind}: bad embedding {tuple(X.shape)}")
        saff = emb.affinities_
        pt = res.phase_times
        pcg = [dg["pcg_iters"] for dg in diags]
        say("fit_sparse", f"{kind}: N={n} backend {emb.backend_}; set-up kNN "
                          f"(approximate) {pt['knn_s']:.2f} s, calibration "
                          f"{pt['calibrate_s']:.2f} s, reverse graph "
                          f"{pt['reverse_s']:.2f} s, spectral init (ELL "
                          f"power iteration) {pt['spectral_init_s']:.2f} s; "
                          f"{res.n_iters} iterations at "
                          f"{res.times[-1] / res.n_iters * 1e3:.1f} ms each; "
                          f"wall {wall:.1f} s")
        say("fit_sparse", f"{kind}: PCG iterations per step {pcg}; ELL "
                          f"launches {counts}; forward graph "
                          f"{_graph_stats(saff.graph)}; reverse graph "
                          f"{_graph_stats(saff.rev)}")
        say("fit_sparse", f"{kind}: energies {np.array2string(e, precision=8)}")
        sparse_attractive.reset_launch_counts()
        plain = Embedding(spec.replace(kernel_impl="torch", max_iters=3)).fit(
            None, X0=emb.X0_, saff=saff)
        if any(sparse_attractive.launch_counts.values()):
            raise AssertionError(
                f"{kind}: the kernel_impl='torch' run launched an ELL kernel:"
                f" {dict(sparse_attractive.launch_counts)}")
        ep = plain.result_.energies
        rel = float(np.max(np.abs(ep - e[:4]) / np.abs(e[:4])))
        if rel > 1e-4:
            raise AssertionError(f"{kind}: kernel path {e[:4]} vs plain path "
                                 f"{ep} (rel {rel:.2e})")
        say("fit_sparse", f"{kind}: first 3 iterations match the "
                          f"kernel_impl='torch' run (same draws), max rel "
                          f"diff {rel:.2e}")
        out["fits"][kind] = emb
    # the other layout on the CG path of the same fit, from the EE fit's
    # graph and start, through the engine loop that fit_sparse runs; its
    # launches are reported apart from the default fits'.  Both layouts sum
    # a row in the same order, so the energies must be the same bits
    emb = out["fits"]["ee"]
    spec = emb.spec
    sparse_attractive.reset_launch_counts()
    t0 = time.perf_counter()
    obj, X0, _ = build_sparse_objective(
        spec, None, emb.X0_, strategy=spec.strategy, saff=emb.affinities_,
        device=emb.X0_.device, ell_layout=other)
    rerun = fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(sparse_attractive.launch_counts)
    if counts[f"ell_lap_matvec_{other}"] < 1:
        raise AssertionError(f"ell_layout={other!r}: launches {counts}")
    out["launches_other_fit"] = counts
    eo, ed = rerun.energies, emb.result_.energies
    if not np.array_equal(eo, ed):
        raise AssertionError(f"ell_layout={other!r} {eo} vs {default} {ed}: "
                             f"not bit-identical")
    say("fit_sparse", f"ee with the CG operator on ell_layout={other!r}: "
                      f"{rerun.n_iters} iterations at "
                      f"{rerun.times[-1] / rerun.n_iters * 1e3:.1f} ms each, "
                      f"wall {wall:.1f} s; launches {counts} (the gradient's "
                      f"stay on the default, {default}); energies "
                      f"bit-identical to the default fit's")
    return out


SECTOR_BYTES = 32    # L2 to SM: one sector for every gather that misses L1


def _gather_line(n_rows: int, k: int, w, ms: float) -> str:
    """The direct gather's second yardstick beside the byte bound, printed
    only: one gathered row a slot, N k of them (padding slots of a row,
    w = 0 and the row's own index, share one line), each a 32-byte L2
    sector when it misses L1.  A count from the shapes and a model, not a
    measurement, so it stays out of the `kernels` line."""
    n_g = n_rows * k
    sectors = n_g * SECTOR_BYTES
    real = int((w != 0).sum())
    return (f"gathers N k = {n_g} ({real} with w != 0), their L2 sectors "
            f"{sectors / 1e6:.1f} MB: {sectors / (ms * 1e-3) / 1e12:.2f} "
            f"TB/s if every gather missed L1")


#: the staged gather's first design (one double-buffered chunk of rows a
#: block, two block barriers a chunk), device time a call by this script's
#: phase time_ell on the EE fit's graphs, NVIDIA H100 80GB HBM3 at 700 W
STAGED_BEFORE_US = {("forward", "float32"): 68.3,
                    ("reverse", "float32"): 171.9,
                    ("forward", "bfloat16"): 64.4,
                    ("reverse", "bfloat16"): 117.9}


def _staged_line(g, ms: float) -> str:
    """The staged gather's count beside its time, printed only: it copies
    the live slots' rows, those whose index is not the row's own."""
    n, k = g.indices.shape
    rows = torch.arange(n, device=g.indices.device, dtype=torch.int32)
    live = int((g.indices != rows[:, None]).sum())
    return (f"{live} gathers of {n * k} slots (those not of the row's own "
            f"index), {live * SECTOR_BYTES / (ms * 1e-3) / 1e12:.2f} TB/s of "
            f"L2 sectors if every one missed L1")


#: what a `kernels` entry takes from a timing dict: numbers measured in
#: this run, and the bound computed from its inputs
KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def kernel_numbers(t: dict) -> dict:
    return {key: t[key] for key in KERNEL_KEYS}


def _laplacian_csr(g):
    """L = diag(sum_j w_nj) - A as one CSR matrix (the library yardstick)."""
    n, k = g.indices.shape
    rows = torch.arange(n, device=g.indices.device)
    r = torch.cat([rows.repeat_interleave(k), rows])
    c = torch.cat([g.indices.reshape(-1).long(), rows])
    v = torch.cat([-g.weights.reshape(-1), g.weights.sum(-1)])
    return torch.sparse_coo_tensor(torch.stack([r, c]), v, (n, n)
                                   ).coalesce().to_sparse_csr()


def phase_time_ell(fits: dict) -> tuple[dict, str]:
    """Each ELL layout on the fits' own forward and reverse graphs at
    N = 70000, float32 and bfloat16, with the embedding of the same fit:
    kernel, plain version and torch.sparse.mm on the CSR Laplacian, each
    call held against the float64 plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_cuda

    out = {}
    for kind, emb in fits.items():
        X = emb.embedding_
        n, d = X.shape
        for gname, g in (("forward", emb.affinities_.graph),
                         ("reverse", emb.affinities_.rev)):
            k = g.k
            for storage, size in (("float32", 4), ("bfloat16", 2)):
                Xs = ops.to_storage(X, storage)
                ws = ops.to_storage(g.weights, storage)
                nbytes = n * k * (4 + size) + n * d * size + n * d * 4
                bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = 3 * n * k * d / PEAK_F32_FLOPS * 1e3
                want = ell_plain64(X, g.indices, g.weights, storage)
                X64 = ops.to_storage(X, storage).double()
                w64 = ops.to_storage(g.weights, storage).double().abs()
                mass = (w64.sum(-1, keepdim=True) * X64.abs()
                        + torch.einsum("nk,nkd->nd", w64,
                                       X64[g.indices].abs()))
                plain_ms = cuda_ms(lambda: ops.ell_lap_matvec(
                    Xs, g.indices, ws, impl="torch"), reps=10)
                csr = _laplacian_csr(g._replace(weights=ws))
                lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, Xs), reps=50)
                lib = torch.sparse.mm(csr, Xs)
                lib_err = float((lib.double() - want).abs().max())
                del csr, lib
                for layout in ELL_LAYOUTS:
                    def call():
                        return ell_lap_matvec_cuda(Xs, g.indices, ws,
                                                   layout=layout)
                    ms = graph_ms(call)
                    eager_ms = cuda_ms(call, reps=200)
                    got = ell_lap_matvec_cuda(Xs, g.indices, ws,
                                              layout=layout)
                    try:
                        err, ratio = ell_compare(got, want, mass)
                    except AssertionError as e:
                        raise AssertionError(
                            f"ELL {layout} != plain on the {kind} fit's "
                            f"{gname} graph {storage}: {e}") from None
                    out[kind, gname, storage, layout] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes" if bound_ms >= t_ops
                        else "operations",
                        "library_ms": lib_ms, "max_abs_err": err}
                    say("time_ell", f"{kind} {gname} graph (N={n}, k={k}, "
                                    f"d={d}) {storage} {layout}: kernel "
                                    f"{ms * 1e3:.1f} us on the device "
                                    f"({bound_ms / ms * 100:.0f}% of the "
                                    f"{nbytes / 1e6:.1f} MB bound "
                                    f"{bound_ms * 1e3:.1f} us; "
                                    f"{eager_ms * 1e3:.1f} us a call issued "
                                    f"eagerly), plain "
                                    f"{plain_ms * 1e3:.1f} us, "
                                    f"torch.sparse.mm CSR {lib_ms * 1e3:.1f}"
                                    f" us (its err {lib_err:.2e}); max abs "
                                    f"err {err:.2e} at {ratio:.2f} of its "
                                    f"bound")
                    if layout == "hbm":
                        before = STAGED_BEFORE_US[gname, storage]
                        say("time_ell", f"  hbm: {_staged_line(g, ms)}; "
                                        f"{bound_ms / ms * 100:.0f}% of the "
                                        f"bound; the first design "
                                        f"{before:.1f} us ("
                                        f"{before * 1e-3 / ms:.2f}x this)")
                        continue
                    say("time_ell", f"  vmem: "
                                    f"{_gather_line(n, k, g.weights, ms)}")
                    if (kind, gname) == ("ee", "forward"):
                        own = torch.arange(n, dtype=torch.int32,
                                           device=X.device)[:, None].expand(
                                               n, k).contiguous()
                        near = g.indices & 1023
                        own_ms = graph_ms(lambda: ell_lap_matvec_cuda(
                            Xs, own, ws))
                        near_ms = graph_ms(lambda: ell_lap_matvec_cuda(
                            Xs, near, ws))
                        say("time_ell", f"  vmem, the same weights with "
                                        f"every index its own row (the "
                                        f"graph streamed, no scattered "
                                        f"gather): {own_ms * 1e3:.1f} us "
                                        f"({bound_ms / own_ms * 100:.0f}% of"
                                        f" the bound); every index folded "
                                        f"into rows [0, 1024) (each gather "
                                        f"an L1 hit): {near_ms * 1e3:.1f} "
                                        f"us")
    wins = [key for key in out if key[3] == "hbm"
            and out[key]["ms"] < out[(*key[:3], "vmem")]["ms"]]
    rule = "hbm" if len(wins) == len(out) // 2 else "vmem"
    say("time_ell", f"the staged gather beat the direct one on {len(wins)} "
                    f"of the {len(out) // 2} graphs and storages, so the "
                    f"rule (faster on all) picks {rule!r}; the default is "
                    f"{ops.ELL_DEFAULT_LAYOUT!r}")
    return out, rule


def phase_profile_sparse(emb, iters: int = 3) -> None:
    """Where a sparse SD iteration's time goes: `iters` iterations of the
    t-SNE fit's objective, continued from its embedding, under
    torch.profiler: device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.embed.engine import LoopConfig, fit_loop
    from repro_torch.embed.trainer import build_sparse_objective

    spec, X = emb.spec, emb.embedding_

    def run(n_iters):
        obj, X0, _ = build_sparse_objective(
            spec, None, X, strategy=spec.strategy, saff=emb.affinities_,
            device=X.device)
        return fit_loop(obj, X0, LoopConfig(max_iters=n_iters, tol=0.0,
                                            ls=spec.resolved_ls(),
                                            seed=spec.seed))

    run(1)                                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        say("profile_sparse", "torch.profiler recorded no device kernels: "
                              "device time and idle share not measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    say("profile_sparse", f"{spec.kind} N={X.shape[0]}: {iters} sparse SD "
                          f"iterations (+ the initial evaluation; "
                          f"{int(res.n_fevals[-1])} energy evaluations) in "
                          f"{wall * 1e3:.1f} ms wall; device busy "
                          f"{busy * 1e3:.1f} ms, idle share "
                          f"{max(0.0, 1 - busy / wall):.2f}")
    for dev_us, key, count in rows[:10]:
        say("profile_sparse", f"  {dev_us / 1e3 / iters:8.3f} ms/iteration "
                              f"{count / iters:7.1f} calls/iteration  "
                              f"{key[:80]}")


# -- slice 3: the tree backend and the cell-interaction kernel ---------------

BH_TABLES = ("16 rows", "65536 rows", "X")
TREE_CHECK_MU = 1e-3     # mu_scale of the tree fits' kernel-vs-plain check
# limit of the kernel path against the all-plain path over three tree
# iterations at the default mu_scale: ~4.5x the EE fit's 2.24e-4 (PERF.md,
# PR 13), the near-singular SD system's spread under a change in the order
# of the ELL products' float32 sums
TREE_DEFAULT_MU_RTOL = 1e-3


def bh_problem(n: int, width: int, d: int, table: str, seed: int, device
               ) -> tuple:
    """X (n, d), a cell-interaction batch idx (n, W) int32 and w (n, W)
    float32, and its table: 16 or 65536 rows of centres of mass, or X itself
    (the near field).  The cases the contract names: ~30% zero-weight slots
    (for table = X, the slots pointing at the row itself among them), rows 3
    and 4 all zero, and row 5 one index repeated.  w holds occupancies."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, d), generator=g, device=device)
    if table == "X":
        tab = X
    else:
        m = 16 if table == "16 rows" else 65536
        tab = 1.5 * torch.randn((m, d), generator=g, device=device)
    m = tab.shape[0]
    idx = torch.randint(0, m, (n, width), generator=g, device=device,
                        dtype=torch.int32)
    w = torch.randint(1, 17, (n, width), generator=g, device=device
                      ).to(torch.float32)
    w = torch.where(torch.rand((n, width), generator=g, device=device) < 0.3,
                    0.0, w)
    if table == "X":
        rows = torch.arange(n, device=device, dtype=torch.int32)[:, None]
        idx[:, 1::5] = rows
        w[:, 1::5] = 0.0
    w[3:5] = 0.0
    idx[5] = idx[5, :1].clone()
    return X, idx, w, tab


def bh_plain64(X, idx, w, table, kind, storage):
    """The plain version in float64 on the storage-rounded inputs, the
    per-entry bounds of s and F, and the float32 underflow floors inside
    them: (s, F, tol_s, tol_F, floor_s, floor_F).  A bound is 5e-5
    (max|want| + |want|) plus 5e-5 times the magnitudes of the terms the
    kernel sums, sum_j |w sp| for s and sum_j |w b (x_n - c_j)| for F (the
    kernel forms each difference, which is exact for close points, so its
    error scales with the terms and not with |x_n| + |c_j|); for epan, whose
    b = [t < 1] jumps at t = 1, F's bound also has the terms w |x_n - c_j|
    of the slots within EPAN_EDGE of it.  The mass term is above the float32
    rounding of a W <= 128 term sum (128 * 2^-24 = 7.6e-6 of it).  The floor
    is what float32 cannot hold: a term whose exp(-t) falls below float32's
    smallest normal number (a far cell of a spread-out EE embedding) may
    lose up to FLT_MIN w (1 + |x_n - c_j|)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import bh_interaction_ref, negative_pair_terms
    X64 = ops.to_storage(X, storage).double()
    t64 = ops.to_storage(table, storage).double()
    w64 = w.double()
    s, F = bh_interaction_ref(X64, idx, w64, t64, kind)
    g = t64[idx]
    diff = X64[:, None, :] - g
    t = torch.sum(diff * diff, dim=-1)
    sp, b = negative_pair_terms(kind, t)
    mass_F = torch.einsum("nw,nwd->nd", (w64 * b).abs(), diff.abs())
    tol_F = TOL_LAP * (F.abs().max() + F.abs() + mass_F)
    if kind == "epan":
        near = ((t - 1.0).abs() < EPAN_EDGE) * w64
        tol_F = tol_F + torch.einsum("nw,nwd->nd", near, diff.abs())
    tol_s = TOL_LAP * (s.abs().max() + s.abs() + (w64 * sp).abs().sum(-1))
    tiny = torch.finfo(torch.float32).tiny
    floor_s = tiny * w64.abs().sum(-1)
    floor_F = tiny * torch.einsum("nw,nwd->nd", w64.abs(), 1.0 + diff.abs())
    return s, F, tol_s + floor_s, tol_F + floor_F, floor_s, floor_F


def bh_compare(got, want, teeth=True) -> tuple[float, float, list]:
    """Max abs error of (s, F), its largest ratio to the bound, and the
    names among s, F whose bound an all-zero output would meet; raises when
    the error exceeds the bound or, with `teeth`, when a bound would pass
    zeros.  (bfloat16 storage of the fits' embeddings may merge neighbours,
    which leaves a near batch with no force to find.)  Entries whose true
    value lies under the float32 underflow floor are left out of the teeth
    test: zero is float32's answer there; a name none of whose entries lies
    above its floor is returned as "s<floor" or "F<floor"."""
    s64, F64, tol_s, tol_F, floor_s, floor_F = want
    err, ratio = 0.0, 0.0
    toothless = []
    for name, g, w, tol, floor in (("s", got[0], s64, tol_s, floor_s),
                                   ("F", got[1], F64, tol_F, floor_F)):
        e, r = bh_held(name, g, w, tol, floor, teeth, toothless)
        err, ratio = max(err, e), max(ratio, r)
    return err, ratio, toothless


def bh_held(name, got, want, tol, floor, teeth, toothless
            ) -> tuple[float, float]:
    """One quantity of `bh_compare`: its max abs error and largest ratio to
    the bound; appends to `toothless` as `bh_compare` says."""
    e = (got.double() - want).abs()
    if not bool(torch.all(e <= tol)):
        raise AssertionError(f"{name}: max abs err {float(e.max()):.3e}")
    held = want.abs() > floor
    if not bool(held.any()):
        toothless.append(f"{name}<floor")
    elif bool(torch.all(want.abs()[held] <= tol[held])):
        toothless.append(name)
        if teeth:
            raise AssertionError(f"{name}: the bound would pass an all-zero "
                                 f"output")
    return float(e.max()), float((e / tol).max())


def phase_check_bh() -> None:
    from repro_torch.kernels import ops
    from repro_torch.kernels.farfield import bh_interaction_cuda
    from repro_torch.kernels.ref import KINDS
    from repro_torch.sparse import make_grid_plan, tree_diagnostics
    n_ok = 0
    worst = 0.0
    for n in (1000, 4097):
        for width in (1, 25, 96, 128):
            for d in (1, 2, 3):
                for ti, table in enumerate(BH_TABLES):
                    X, idx, w, tab = bh_problem(
                        n, width, d, table, seed=n + 7 * width + 3 * d + ti,
                        device="cuda")
                    for storage in ("float32", "bfloat16"):
                        Xs = ops.to_storage(X, storage)
                        tabs = ops.to_storage(tab, storage)
                        for kind in KINDS:
                            want = bh_plain64(X, idx, w, tab, kind, storage)
                            got = bh_interaction_cuda(Xs, idx, w, tabs, kind)
                            torch.cuda.synchronize()
                            case = (f"n={n} W={width} d={d} table={table} "
                                    f"{storage} {kind}")
                            try:
                                _, ratio, _ = bh_compare(got, want)
                            except AssertionError as e:
                                raise AssertionError(
                                    f"BH kernel != plain at {case}: {e}"
                                ) from None
                            if not (bool(torch.all(got[0][3:5] == 0))
                                    and bool(torch.all(got[1][3:5] == 0))):
                                raise AssertionError(f"all-zero rows not 0 "
                                                     f"at {case}")
                            again = bh_interaction_cuda(Xs, idx, w, tabs,
                                                        kind)
                            if not (torch.equal(got[0], again[0])
                                    and torch.equal(got[1], again[1])):
                                raise AssertionError(f"rerun not "
                                                     f"bit-identical at "
                                                     f"{case}")
                            worst = max(worst, ratio)
                            n_ok += 1
    say("check_bh", f"{n_ok} cases (N in 1000/4097 x W in 1/25/96/128 x d "
                    f"in 1/2/3 x tables of 16 rows, 65536 rows and X x "
                    f"f32/bf16 x five kinds, with zero-weight slots, all-zero "
                    f"rows and a repeated index) match the float64 plain "
                    f"version, reruns bit-identical, all-zero rows exactly "
                    f"0; worst error at {worst:.2f} of its bound")
    n = 4000
    g = torch.Generator(device="cuda").manual_seed(n)
    X = torch.randn((n, 2), generator=g, device="cuda")
    diag = tree_diagnostics(X, make_grid_plan(n))
    pairs = float(diag["tree_pairs"])
    if pairs != n * (n - 1):
        raise AssertionError(f"tree_pairs {pairs} != n (n - 1) = "
                             f"{n * (n - 1)} at N={n}")
    say("check_bh", f"N={n} on the card: tree_pairs {pairs:.0f} = "
                    f"n (n - 1) exactly; theta ratio "
                    f"{float(diag['tree_theta_ratio']):.4f} <= 0.5")


def bh_tree_plain64(X, batches, chunk, kind, storage) -> tuple:
    """The float64 plain version of one whole evaluation, for the fused
    kernel: per batch, its chunks' (s, bound, floor) of `bh_plain64` summed;
    over the batches, F's (F, bound, floor) summed.  The fused kernel adds
    the chunks' float32 sums as the per-batch path does, so the sum of the
    chunks' bounds holds it."""
    rows, F = [], None
    for b in batches:
        acc = None
        for c0 in range(0, b.idx.shape[1], chunk):
            cols = slice(c0, c0 + chunk)
            part = bh_plain64(X, b.idx[:, cols], b.w[:, cols], b.table, kind,
                              storage)
            acc = part if acc is None else tuple(
                a + p for a, p in zip(acc, part))
        rows.append((acc[0], acc[2], acc[4]))
        F_b = (acc[1], acc[3], acc[5])
        F = F_b if F is None else tuple(a + p for a, p in zip(F, F_b))
    return rows, F


def bh_tree_compare(got, want, tags, teeth) -> tuple[float, float, list]:
    """`bh_compare` for a fused evaluation: its s rows (named by the batches'
    tags) and F against `bh_tree_plain64`."""
    (s_rows, F), (rows, F64) = got, want
    err, ratio, toothless = 0.0, 0.0, []
    for tag, s, (s64, tol, floor) in zip(tags, s_rows, rows):
        e, r = bh_held(f"{tag} s", s, s64, tol, floor, teeth, toothless)
        err, ratio = max(err, e), max(ratio, r)
    e, r = bh_held("F", F, *F64, teeth, toothless)
    return max(err, e), max(ratio, r), toothless


def phase_check_bh_fits(fits: dict) -> None:
    """Every per-batch kernel call of one evaluation (the far levels, the
    near batch's chunks, the residual) on each tree fit's embedding, float32
    and bfloat16, against the float64 plain version: the EE fit holds the
    exp instantiation, the t-SNE fit the 1/(1 + t) one, at the shapes and
    data the main path gives them.  Then the fused kernel on the same
    embedding: each batch's s row and F bit-equal to the per-batch path's
    sums of those calls, and within the sums of their bounds of the float64
    plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.farfield import bh_interaction_cuda
    from repro_torch.sparse import farfield as ff

    for kind, emb in fits.items():
        X = emb.embedding_
        plan = ff.make_grid_plan(X.shape[0], theta=emb.spec.theta)
        calls, worst, below = 0, 0.0, set()
        batches = ff._interaction_batches(X, plan)
        for b in batches:
            width = b.idx.shape[1]
            for c0 in range(0, width, plan.chunk):
                cols = slice(c0, min(c0 + plan.chunk, width))
                idx, w = b.idx[:, cols], b.w[:, cols]
                for storage in ("float32", "bfloat16"):
                    Xs = ops.to_storage(X, storage)
                    tabs = (Xs if b.table is X
                            else ops.to_storage(b.table, storage))
                    got = bh_interaction_cuda(Xs, idx, w, tabs, kind)
                    try:
                        _, ratio, toothless = bh_compare(
                            got, bh_plain64(X, idx, w, b.table, kind,
                                            storage),
                            teeth=storage == "float32")
                    except AssertionError as e:
                        raise AssertionError(
                            f"BH kernel != plain on the {kind} tree fit's "
                            f"{b.tag} batch, columns {c0}..{cols.stop} "
                            f"{storage}: {e}") from None
                    below.update(f"{b.tag} {storage} {t}" for t in toothless)
                    worst = max(worst, ratio)
                    calls += 1
        say("check_bh", f"{kind} tree fit (N={X.shape[0]}): the {calls // 2} "
                        f"per-batch kernel calls of an evaluation, float32 "
                        f"and bfloat16, match the float64 plain version, "
                        f"worst error at {worst:.2f} of its bound; bounds "
                        f"that would pass zeros (bfloat16 only) or whose "
                        f"every entry lies under float32's underflow floor: "
                        f"{', '.join(sorted(below)) or 'none'}")
        grid = ff._grid_state(X, plan)
        worst, below = 0.0, []
        for storage in ("float32", "bfloat16"):
            got = ops.bh_tree(grid, kind, impl="kernel",
                              storage_dtype=storage)
            F_want = torch.zeros_like(X)
            for row, b in zip(got[0], batches):
                s_b, F_b = ff._apply_chunked(X, b, kind, plan.chunk,
                                             {"storage_dtype": storage})
                if not torch.equal(row, s_b):
                    raise AssertionError(f"fused kernel's {b.tag} s row != "
                                         f"the per-batch kernel path's on "
                                         f"the {kind} tree fit, {storage}")
                F_want = F_want + F_b
            if not torch.equal(got[1], F_want):
                raise AssertionError(f"fused kernel's F != the per-batch "
                                     f"kernel path's on the {kind} tree fit, "
                                     f"{storage}")
            try:
                _, ratio, toothless = bh_tree_compare(
                    got, bh_tree_plain64(X, batches, plan.chunk, kind,
                                         storage),
                    [b.tag for b in batches], teeth=storage == "float32")
            except AssertionError as e:
                raise AssertionError(f"fused kernel != plain on the {kind} "
                                     f"tree fit, {storage}: {e}") from None
            worst = max(worst, ratio)
            below += [f"{storage} {t}" for t in toothless]
        say("check_bh", f"{kind} tree fit: the fused kernel (one launch, "
                        f"{grid.n_batches} s rows and F), float32 and "
                        f"bfloat16, is bit-equal to the per-batch kernel "
                        f"path and within the summed bounds of the float64 "
                        f"plain version, worst at {worst:.2f}; bounds that "
                        f"would pass zeros (bfloat16 only) or under the "
                        f"floor: {', '.join(below) or 'none'}")


def _rel_gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(b) - a) / np.abs(a)))


@contextlib.contextmanager
def plain_bh_only():
    """`ops.bh_tree` on its plain version while every other kernel runs as
    the spec says: a fit under it differs from the kernel path by the cell
    interaction alone."""
    from repro_torch.kernels import ops
    kernel = ops.bh_tree
    ops.bh_tree = lambda *args, **kwargs: kernel(*args,
                                                 **{**kwargs, "impl": "torch"})
    try:
        yield
    finally:
        ops.bh_tree = kernel


@contextlib.contextmanager
def per_batch_tree():
    """`tree_repulsion` through the materialised batches and the per-batch
    kernel (`_tree_repulsion_batched`), the path before the fused kernel."""
    from repro_torch.sparse import farfield as ff
    fused = ff.tree_repulsion
    ff.tree_repulsion = ff._tree_repulsion_batched
    try:
        yield
    finally:
        ff.tree_repulsion = fused


def _evals_launches(plan) -> int:
    """Per-batch kernel launches an evaluation of the tree: one per far
    level, one per chunk of the near batch, one for the residual."""
    near = (2 * plan.r + 1) ** 2 * plan.cap
    return (plan.depth - plan.l1 + 1) + (near + plan.chunk - 1) // plan.chunk + 1


def phase_fit_tree(sparse_fits: dict, iters: int = 10) -> dict:
    """The slice-3 main path: `Embedding(EmbedSpec(kind=..., backend="tree",
    strategy="sd"))` on the N = 70000 sparse fits' affinities."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.kernels import farfield, sparse_attractive
    from repro_torch.sparse import make_grid_plan

    out = {"launches": 0, "launches_main_per_batch": 0,
           "launches_per_batch": 0, "fits": {}}
    for kind, fit in sparse_fits.items():
        saff = fit.affinities_
        lam = fit.spec.lam
        n = saff.graph.n
        spec = EmbedSpec(kind=kind, lam=lam, perplexity=30.0, backend="tree",
                         strategy="sd", max_iters=iters, tol=0.0)
        plan = make_grid_plan(n, theta=spec.theta)
        per_eval = _evals_launches(plan)
        farfield.reset_launch_counts()
        t0 = time.perf_counter()
        emb = Embedding(spec).fit(None, saff=saff)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = emb.result_
        launches = farfield.launch_counts["bh_tree"]
        evals = int(res.n_fevals[-1])
        if emb.backend_ != "tree":
            raise AssertionError(f"{kind}: backend {emb.backend_!r}")
        if launches < 1 or farfield.launch_counts != {"bh_tree": evals,
                                                      "bh_interaction": 0}:
            raise AssertionError(f"{kind}: kernel launches "
                                 f"{dict(farfield.launch_counts)} for {evals} "
                                 f"evaluations; want one fused launch each")
        out["launches"] += launches
        out["launches_main_per_batch"] += farfield.launch_counts[
            "bh_interaction"]
        e = res.energies
        if not np.all(np.isfinite(e)):
            raise AssertionError(f"{kind}: non-finite energies {e}")
        if np.any(np.diff(e) > 0):
            raise AssertionError(f"{kind}: energy increased: {e}")
        X = emb.embedding_
        if tuple(X.shape) != (n, 2) or not bool(torch.isfinite(X).all()):
            raise AssertionError(f"{kind}: bad embedding {tuple(X.shape)}")
        say("fit_tree", f"{kind}: N={n} plan r={plan.r} l1={plan.l1} depth "
                        f"{plan.depth} cap {plan.cap}; spectral init (ELL "
                        f"power iteration) "
                        f"{res.phase_times['spectral_init_s']:.2f} s; "
                        f"{res.n_iters} iterations at "
                        f"{res.times[-1] / res.n_iters * 1e3:.1f} ms each "
                        f"({evals} evaluations); fused kernel launches "
                        f"{launches} (one an evaluation), per-batch kernel "
                        f"launches 0; wall {wall:.1f} s")
        say("fit_tree", f"{kind}: energies {np.array2string(e, precision=8)}")
        # the default mu_scale: the kernel path against a run in which only
        # the cell-interaction kernel is replaced by its plain version (the
        # ELL kernels run in both), at rtol 1e-4.  Then the all-plain path
        # (kernel_impl="torch", no kernel at all): the SD system is
        # near-singular there (its small eigenvalues, ~mu, belong to the
        # clusters' translations) and PCG stops at its cap, so the order of
        # the ELL products' float32 sums moves the EE trajectory by ~2.2e-4
        # (PERF.md, PR 13); it is held to TREE_DEFAULT_MU_RTOL.  The rtol
        # 1e-4 check of the whole plain path runs at mu_scale = 1e-3, as the
        # CPU parity tests do (tests/test_torch_farfield.py).
        mu0 = spec.mu_scale
        kern = {mu0: e[:4], TREE_CHECK_MU: Embedding(
            spec.replace(max_iters=3, mu_scale=TREE_CHECK_MU)).fit(
                None, X0=emb.X0_, saff=saff).result_.energies}
        farfield.reset_launch_counts()
        sparse_attractive.reset_launch_counts()
        with plain_bh_only():
            bh_plain = Embedding(spec.replace(max_iters=3)).fit(
                None, X0=emb.X0_, saff=saff).result_.energies
        if (any(farfield.launch_counts.values())
                or not any(sparse_attractive.launch_counts.values())):
            raise AssertionError(
                f"{kind}: the run with the plain cell interaction launched "
                f"{dict(farfield.launch_counts)} "
                f"{dict(sparse_attractive.launch_counts)}")
        gaps = {"bh": _rel_gap(kern[mu0], bh_plain)}
        for mu in (mu0, TREE_CHECK_MU):
            farfield.reset_launch_counts()
            sparse_attractive.reset_launch_counts()
            plain = Embedding(spec.replace(kernel_impl="torch", max_iters=3,
                                           mu_scale=mu)).fit(
                None, X0=emb.X0_, saff=saff).result_.energies
            if (any(farfield.launch_counts.values())
                    or any(sparse_attractive.launch_counts.values())):
                raise AssertionError(
                    f"{kind}: the kernel_impl='torch' run launched a kernel: "
                    f"{dict(farfield.launch_counts)} "
                    f"{dict(sparse_attractive.launch_counts)}")
            gaps[mu] = _rel_gap(kern[mu], plain)
            if mu == mu0:
                gaps["ell"] = _rel_gap(bh_plain, plain)
        for gap, limit, what in (
                (gaps["bh"], 1e-4, f"only the cell interaction plain, "
                                   f"mu_scale={mu0}"),
                (gaps[mu0], TREE_DEFAULT_MU_RTOL,
                 f"kernel_impl='torch', mu_scale={mu0}"),
                (gaps[TREE_CHECK_MU], 1e-4,
                 f"kernel_impl='torch', mu_scale={TREE_CHECK_MU}")):
            if gap > limit:
                raise AssertionError(f"{kind}: first 3 iterations of the "
                                     f"kernel path against the run with "
                                     f"{what}: max rel diff {gap:.2e} > "
                                     f"{limit:.0e}")
        say("fit_tree", f"{kind}: first 3 iterations of the kernel path, max "
                        f"rel diff against: the cell interaction alone on its "
                        f"plain version {gaps['bh']:.2e} (rtol 1e-4; ELL "
                        f"kernels in both), the all-plain kernel_impl='torch' "
                        f"run (no kernel launched) {gaps[mu0]:.2e} (limit "
                        f"{TREE_DEFAULT_MU_RTOL:.0e}), at the default "
                        f"mu_scale={mu0}; the all-plain run against the "
                        f"cell-interaction-plain run (the ELL kernels' part) "
                        f"{gaps['ell']:.2e}; at mu_scale={TREE_CHECK_MU} the "
                        f"all-plain run {gaps[TREE_CHECK_MU]:.2e} (rtol 1e-4)")
        # a second kernel run: bit-identical, with the grid's diagnostics
        diags = []
        again = Embedding(spec.replace(max_iters=3)).fit(
            None, X0=emb.X0_, saff=saff,
            callback=lambda it, X, en, dg: diags.append(dg))
        ra = again.result_
        if not (np.array_equal(ra.energies, e[:4])
                and np.array_equal(ra.grad_norms, res.grad_norms[:4])
                and np.array_equal(ra.step_sizes, res.step_sizes[:3])):
            raise AssertionError(f"{kind}: a second kernel run is not "
                                 f"bit-identical: {ra.energies} vs {e[:4]}")
        for dg in diags:
            say("fit_tree", f"{kind}: it {dg['it']}: tree_cells "
                            f"{dg['tree_cells']:.2f}, tree_theta_ratio "
                            f"{dg['tree_theta_ratio']:.4f}, tree_overflow "
                            f"{dg['tree_overflow']:.0f}, tree_pairs rel err "
                            f"{abs(dg['tree_pairs'] - n * (n - 1)) / (n * (n - 1)):.2e}"
                            f" (a float32 sum), PCG iterations "
                            f"{dg['pcg_iters']:.0f}")
        say("fit_tree", f"{kind}: a second kernel run of 3 iterations is "
                        f"bit-identical (energies, gradient norms, steps)")
        # the same 3 iterations through the per-batch kernel path: the fused
        # kernel sums in its order, so the trace must not move by a bit
        farfield.reset_launch_counts()
        with per_batch_tree():
            rb = Embedding(spec.replace(max_iters=3)).fit(
                None, X0=emb.X0_, saff=saff).result_
        evals_b = int(rb.n_fevals[-1])
        if farfield.launch_counts != {"bh_tree": 0,
                                      "bh_interaction": per_eval * evals_b}:
            raise AssertionError(f"{kind}: the per-batch rerun launched "
                                 f"{dict(farfield.launch_counts)} for "
                                 f"{evals_b} evaluations of {per_eval} "
                                 f"batches and chunks")
        if not (np.array_equal(rb.energies, e[:4])
                and np.array_equal(rb.grad_norms, res.grad_norms[:4])
                and np.array_equal(rb.step_sizes, res.step_sizes[:3])):
            raise AssertionError(f"{kind}: the per-batch kernel path's 3 "
                                 f"iterations differ from the fused path's: "
                                 f"{rb.energies} vs {e[:4]}")
        out["launches_per_batch"] += farfield.launch_counts["bh_interaction"]
        say("fit_tree", f"{kind}: 3 iterations through the per-batch kernel "
                        f"path ({farfield.launch_counts['bh_interaction']} "
                        f"launches, {per_eval} an evaluation) give the fused "
                        f"path's bits (energies, gradient norms, steps)")
        out["fits"][kind] = emb
    return out


def phase_time_bh(emb) -> dict:
    """The per-batch kernel at the tree's batch shapes on the t-SNE tree
    fit's embedding (the batches its next evaluation would run), float32 and
    bfloat16: CUDA-event time, the byte bound and the plain version, each
    call held against the float64 plain version; the fused kernel over the
    whole evaluation likewise (`_time_bh_tree`).  Then one whole
    tree_repulsion before (per-batch path) and after (fused), against its
    grid state alone, the state with its expansion, and the per-batch kernel
    calls alone."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.farfield import bh_interaction_cuda
    from repro_torch.sparse import farfield as ff

    X = emb.embedding_
    n, d = X.shape
    plan = ff.make_grid_plan(n, theta=emb.spec.theta)
    batches = {b.tag: b for b in ff._interaction_batches(X, plan)}
    near = batches["near"]
    # the near chunk that holds the own cell's listed slots (offset (0, 0),
    # the middle of the window), so that it has live slots however sparse
    # the neighbouring cells are
    own = (2 * plan.r + 1) ** 2 // 2 * plan.cap
    c0 = own // plan.chunk * plan.chunk
    cols = slice(c0, min(c0 + plan.chunk, near.idx.shape[1]))
    shapes = {f"far-l{plan.depth}": batches[f"far-l{plan.depth}"],
              "near chunk": ff._Batch(idx=near.idx[:, cols],
                                      w=near.w[:, cols], table=near.table,
                                      h_cell=0.0, tag="near chunk"),
              "residual": batches["residual"]}
    kind = emb.spec.kind
    out = {}
    for name, b in shapes.items():
        width = b.idx.shape[1]
        m = b.table.shape[0]
        live = float((b.w > 0).float().mean())
        for storage, size in (("float32", 4), ("bfloat16", 2)):
            Xs = ops.to_storage(X, storage)
            # idx and w, X, the table and the outputs once each; the near
            # batch's table is X itself, read once with it
            tabs = Xs if b.table is X else ops.to_storage(b.table, storage)
            tab_bytes = 0 if b.table is X else m * d * size
            nbytes = (n * width * 8 + n * d * size + tab_bytes + n * 4
                      + n * d * 4)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = (3 * d + 4) * n * width / PEAK_F32_FLOPS * 1e3
            bound_ms = max(t_bytes, t_ops)
            def call():
                return bh_interaction_cuda(Xs, b.idx, b.w, tabs, kind)
            ms = graph_ms(call)
            eager_ms = cuda_ms(call, reps=200)
            plain_ms = cuda_ms(lambda: ops.bh_interaction(
                Xs, b.idx, b.w, tabs, kind, impl="torch"), reps=20)
            got = bh_interaction_cuda(Xs, b.idx, b.w, tabs, kind)
            try:
                err, ratio, toothless = bh_compare(
                    got, bh_plain64(X, b.idx, b.w, b.table, kind, storage),
                    teeth=storage == "float32")
            except AssertionError as e:
                raise AssertionError(f"BH kernel != plain on the {name} "
                                     f"batch {storage}: {e}") from None
            out[name, storage] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None, "max_abs_err": err}
            say("time_bh", f"{kind} {name} (N={n}, W={width}, M={m}, d={d}, "
                           f"{live * 100:.1f}% live slots) {storage}: kernel "
                           f"{ms * 1e3:.1f} us on the device "
                           f"({bound_ms / ms * 100:.0f}% of the "
                           f"{nbytes / 1e6:.1f} MB bound "
                           f"{bound_ms * 1e3:.1f} us; {eager_ms * 1e3:.1f} "
                           f"us a call issued eagerly), plain "
                           f"{plain_ms * 1e3:.1f} us; max abs err "
                           f"{err:.2e} at {ratio:.2f} of its bound (bounds "
                           f"that would pass zeros: "
                           f"{'/'.join(toothless) or 'none'}); no single "
                           f"PyTorch call computes it (library_ms null)")
    out.update(_time_bh_tree(X, plan, kind, list(batches.values())))
    all_batches = list(batches.values())
    before_ms = cuda_ms(lambda: ff._tree_repulsion_batched(X, plan, kind),
                        reps=20)
    after_ms = cuda_ms(lambda: ff.tree_repulsion(X, plan, kind), reps=20)
    state_ms = cuda_ms(lambda: ff._grid_state(X, plan), reps=20)
    grid_ms = cuda_ms(lambda: ff._interaction_batches(X, plan), reps=20)
    kern_ms = graph_ms(lambda: [ff._apply_chunked(X, b, kind, plan.chunk, {})
                                for b in all_batches], reps=5)
    say("time_bh", f"{kind} one tree_repulsion (N={n}), a call issued "
                   f"eagerly: before, through the batches and "
                   f"{_evals_launches(plan)} per-batch kernel calls, "
                   f"{before_ms:.3f} ms; after, one fused launch, "
                   f"{after_ms:.3f} ms.  Parts: the grid state alone "
                   f"{state_ms:.3f} ms; the state and its expansion into "
                   f"batches (plain PyTorch) {grid_ms:.3f} ms; the per-batch "
                   f"kernel calls and sums alone {kern_ms:.3f} ms on the "
                   f"device (CUDA graph)")
    out["evaluation"] = {"before_ms": before_ms, "after_ms": after_ms,
                         "state_ms": state_ms, "grid_ms": grid_ms,
                         "kernels_ms": kern_ms}
    return out


# integer operations the decomposition needs to test one window cell of a
# row (the reference's batch build, not the kernel's code): a far cell's
# target coords (2), in-bounds test (4), parent-cell Chebyshev distance and
# its test (8) and cell id (2); a near cell's coords, bounds and cell id
# (8), which the residual reuses; and a listed near slot's position and
# self test (2)
FAR_TEST_OPS = 16
NEAR_TEST_OPS = 8
NEAR_SLOT_OPS = 2


def _time_bh_tree(X, plan, kind, batches) -> dict:
    """The fused kernel over one evaluation, float32 and bfloat16: device
    time of the launch alone on a packed state (CUDA graph), an eager call
    with its packing (`bh_tree_cuda`), the plain version (`ops.bh_tree`,
    impl="torch"), and the bound by the operations these inputs need: one
    test of each far, near and residual window cell of every row
    (FAR_TEST_OPS, NEAR_TEST_OPS; the residual shares the near cell's),
    NEAR_SLOT_OPS a listed near slot, and 3 d + 4 float operations a live
    slot (as the per-batch bound counts them), all at the f32 rate (the
    data sheet gives no int32 rate; the card's is half its f32 rate, so
    this bound is low), against the bytes of the state read once and the
    outputs written once."""
    from repro_torch.kernels import farfield, ops
    from repro_torch.sparse import farfield as ff

    n, d = X.shape
    grid = ff._grid_state(X, plan)
    slots = sum(b.w.numel() for b in batches)
    live = sum(int((b.w > 0).sum()) for b in batches)
    near = next(b for b in batches if b.tag == "near")
    listed = int((near.w > 0).sum())
    far_tests = n * (plan.depth - plan.l1 + 1) * grid.far_offsets.shape[0]
    near_tests = n * grid.near_offsets.shape[0]
    tests = far_tests + near_tests
    n_ops = (FAR_TEST_OPS * far_tests + NEAR_TEST_OPS * near_tests
             + NEAR_SLOT_OPS * listed + (3 * d + 4) * live)
    out = {}
    for storage, size in (("float32", 4), ("bfloat16", 2)):
        g = dataclasses.replace(
            grid, Xs=ops.to_storage(grid.Xs, storage),
            res_com=ops.to_storage(grid.res_com, storage),
            level_com=tuple(ops.to_storage(c, storage)
                            for c in grid.level_com))
        packed = farfield.pack_tree(g)
        m_lvl = packed.lvl_counts.numel()
        m_res = packed.res_cnt.numel()
        nbytes = (n * d * size + 2 * n * 4 + 3 * m_res * 4 + m_lvl * 4
                  + (m_lvl + m_res) * d * size + grid.n_batches * n * 4
                  + n * d * 4)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_F32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        ms = graph_ms(lambda: farfield.launch_tree(packed, kind))
        eager_ms = cuda_ms(lambda: farfield.bh_tree_cuda(g, kind), reps=100)
        plain_ms = cuda_ms(lambda: ops.bh_tree(grid, kind, impl="torch",
                                               storage_dtype=storage), reps=3)
        try:
            err, worst, below = bh_tree_compare(
                farfield.launch_tree(packed, kind),
                bh_tree_plain64(X, batches, plan.chunk, kind, storage),
                [b.tag for b in batches], teeth=storage == "float32")
        except AssertionError as e:
            raise AssertionError(f"fused kernel != plain on the {kind} tree "
                                 f"fit, {storage}: {e}") from None
        out["fused", storage] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "max_abs_err": err}
        say("time_bh", f"{kind} fused kernel, one evaluation (N={n}, "
                       f"{tests / 1e6:.1f} M window tests, {slots / 1e6:.1f} "
                       f"M slots, {live / slots * 100:.1f}% live) {storage}: "
                       f"{ms * 1e3:.1f} us on the device "
                       f"({bound_ms / ms * 100:.0f}% of the bound "
                       f"{bound_ms * 1e3:.1f} us by {n_ops / 1e9:.2f} G "
                       f"operations; {nbytes / 1e6:.1f} MB would take "
                       f"{t_bytes * 1e3:.1f} us); {eager_ms * 1e3:.1f} us a "
                       f"call with its packing issued eagerly; plain "
                       f"{plain_ms:.2f} ms; max abs err {err:.2e} at "
                       f"{worst:.2f} of its bound (bounds that would pass "
                       f"zeros: {'/'.join(below) or 'none'}); no single "
                       f"PyTorch call computes it (library_ms null)")
    return out


def phase_profile_tree(emb, iters: int = 3) -> None:
    """Where a tree SD iteration's time goes: `iters` iterations of the
    t-SNE tree fit's objective, continued from its embedding, under
    torch.profiler: device time by kernel and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.embed.engine import LoopConfig, fit_loop
    from repro_torch.embed.trainer import build_tree_objective

    spec, X = emb.spec, emb.embedding_

    def run(n_iters):
        obj, X0, _ = build_tree_objective(
            spec, None, X, strategy=spec.strategy, saff=emb.affinities_,
            device=X.device)
        return fit_loop(obj, X0, LoopConfig(max_iters=n_iters, tol=0.0,
                                            ls=spec.resolved_ls(),
                                            seed=spec.seed))

    run(1)                                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        say("profile_tree", "torch.profiler recorded no device kernels: "
                            "device time and idle share not measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    say("profile_tree", f"{spec.kind} N={X.shape[0]}: {iters} tree SD "
                        f"iterations (+ the initial evaluation; "
                        f"{int(res.n_fevals[-1])} energy evaluations) in "
                        f"{wall * 1e3:.1f} ms wall; device busy "
                        f"{busy * 1e3:.1f} ms, idle share "
                        f"{max(0.0, 1 - busy / wall):.2f}")
    for dev_us, key, count in rows[:12]:
        say("profile_tree", f"  {dev_us / 1e3 / iters:8.3f} ms/iteration "
                            f"{count / iters:7.1f} calls/iteration  "
                            f"{key[:80]}")
    for name, what in (("bh_tree", "the fused cell interaction"),
                       ("bh_rows", "the per-batch cell interaction")):
        bh = [(us, c) for us, key, c in rows if name in key]
        bh_us, bh_calls = sum(r[0] for r in bh), sum(r[1] for r in bh)
        say("profile_tree", f"  {what} ({name}): "
                            f"{bh_us / 1e3 / iters:.3f} ms/iteration, "
                            f"{bh_calls / iters:.1f} calls/iteration, "
                            f"{bh_us / max(bh_calls, 1):.1f} us a call")


# -- slice 5: the row-sharded sparse backend and the local-rows kernel -------

# (row0, nb) of the checks and timings: the one rank of this card, and the
# two shards of a 2-rank split of N = 70000
SHARDS = ((0, N_SPARSE), (0, N_SPARSE // 2), (N_SPARSE // 2, N_SPARSE // 2))
SHARDED_CHECK_MU = 1e-3   # mu_scale of the sharded fits' rtol 1e-4 checks
# limit of the sharded fit against the single-device sparse fit at the
# default mu_scale, where the near-singular SD system moves trajectories by
# the order of float32 sums (ROADMAP Queue 3), as PR 13 held its tree fits
SHARDED_DEFAULT_MU_RTOL = 1e-3
SHARDED_DIR = ROOT / "build" / "chip_smoke_sharded"   # git-ignored
SPAWN_TIMEOUT_S = 300


def phase_check_ell_local(fits: dict) -> None:
    """The local-rows kernel against its float64 plain version on row
    slices of the N = 70000 EE fit's forward and reverse graphs: one rank's
    rows and each half of a 2-rank split, float32 and bfloat16, d in
    {1, 2, 3}, with phase `check_ell`'s bound (which an all-zero output
    fails); reruns must be bit-identical."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_local_cuda

    saff = fits["ee"].affinities_
    n_ok, worst = 0, 0.0
    for gname, g in (("forward", saff.graph), ("reverse", saff.rev)):
        n = g.n
        for d in (1, 2, 3):
            gen = torch.Generator(device="cuda").manual_seed(d)
            X = torch.randn((n, d), generator=gen, device="cuda")
            for storage in ("float32", "bfloat16"):
                Xs = ops.to_storage(X, storage)
                ws = ops.to_storage(g.weights, storage)
                want = ell_plain64(X, g.indices, g.weights, storage)
                for row0, nb in SHARDS:
                    rows = slice(row0, row0 + nb)
                    idx_l, w_l = g.indices[rows].clone(), ws[rows].clone()
                    got = ell_lap_matvec_local_cuda(Xs, idx_l, w_l, row0)
                    torch.cuda.synchronize()
                    case = (f"{gname} graph (k={g.k}) d={d} {storage} "
                            f"row0={row0} nb={nb}")
                    try:
                        _, ratio = ell_compare(got, want[rows])
                    except AssertionError as e:
                        raise AssertionError(f"local ELL kernel != plain at "
                                             f"{case}: {e}") from None
                    again = ell_lap_matvec_local_cuda(Xs, idx_l, w_l, row0)
                    if not torch.equal(got, again):
                        raise AssertionError(f"rerun not bit-identical at "
                                             f"{case}")
                    worst = max(worst, ratio)
                    n_ok += 1
    say("check_ell_local", f"{n_ok} cases (the N={N_SPARSE} EE fit's forward "
                           f"and reverse graphs x rows [0, 70000), [0, 35000)"
                           f" and [35000, 70000) x d in 1/2/3 x f32/bf16) "
                           f"match the float64 plain version, reruns "
                           f"bit-identical; worst error at {worst:.2f} of its "
                           f"bound")


def _start_nccl_group() -> None:
    """A one-rank NCCL group on this card, in this process, through a
    file:// store under the build directory."""
    SHARDED_DIR.mkdir(parents=True, exist_ok=True)
    store = SHARDED_DIR / "nccl-store"
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))


def _sharded_run(spec, saff, X0, mesh, iters: int, mu: float, **spec_kw):
    """The trainer-level sharded fit from a given graph and start (the
    sharded backend's Embedding takes no saff=, as the reference's)."""
    from repro_torch.embed.engine import fit_loop, make_loop_config
    from repro_torch.embed.trainer import build_sparse_objective
    spec = spec.replace(max_iters=iters, mu_scale=mu, **spec_kw)
    obj, X0, _ = build_sparse_objective(
        spec, None, X0, strategy=spec.strategy, sharded=True, saff=saff,
        device=X0.device, mesh=mesh)
    return fit_loop(obj, X0, make_loop_config(spec, spec.resolved_ls()))


def phase_fit_sharded(sparse: dict) -> dict:
    """The slice-5 main path: `Embedding(EmbedSpec(kind=...,
    backend="sparse-sharded"), mesh=...)` in a one-rank NCCL group on the
    N = 70000 data of phase `fit_sparse`, EE and t-SNE, ten iterations."""
    from repro_torch.api import Embedding
    from repro_torch.kernels import sparse_attractive
    from repro_torch.launch import make_host_mesh

    _start_nccl_group()
    mesh = make_host_mesh()
    say("fit_sharded", f"NCCL process group: {mesh.size} rank(s), mesh "
                       f"{mesh.shape}")
    out = {"launches": 0, "fits": {}, "mesh": mesh, "traces": {}}
    for kind, single in sparse["fits"].items():
        spec = single.spec.replace(backend="sparse-sharded")
        sparse_attractive.reset_launch_counts()
        diags = []
        t0 = time.perf_counter()
        emb = Embedding(spec, mesh=mesh).fit(
            sparse["Y"], callback=lambda it, X, e, dg: diags.append(dg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(sparse_attractive.launch_counts)
        if emb.backend_ != "sparse-sharded":
            raise AssertionError(f"{kind}: backend {emb.backend_!r}")
        if (counts["ell_lap_matvec_local"] < 1 or counts["ell_lap_matvec_vmem"]
                or counts["ell_lap_matvec_hbm"]):
            raise AssertionError(f"{kind}: the sharded fit's ELL launches "
                                 f"{counts} (the local-rows kernel only)")
        out["launches"] += counts["ell_lap_matvec_local"]
        res = emb.result_
        e = res.energies
        if not np.all(np.isfinite(e)) or not e[-1] < e[0]:
            raise AssertionError(f"{kind}: energies {e}")
        X = emb.embedding_
        if tuple(X.shape) != (N_SPARSE, 2) or not bool(
                torch.isfinite(X).all()):
            raise AssertionError(f"{kind}: bad embedding {tuple(X.shape)}")
        saff, ref = emb.affinities_, single.affinities_
        same_graph = all(torch.equal(a, b) for a, b in zip(
            (saff.graph.indices, saff.graph.weights, saff.rev.indices,
             saff.rev.weights),
            (ref.graph.indices, ref.graph.weights, ref.rev.indices,
             ref.rev.weights)))
        if not same_graph or not torch.equal(emb.X0_, single.X0_):
            raise AssertionError(f"{kind}: the sharded fit's graph or start "
                                 f"differs from the sparse fit's")
        pt = res.phase_times
        say("fit_sharded", f"{kind}: N={N_SPARSE} backend {emb.backend_}; "
                           f"graph and spectral start equal the sparse fit's;"
                           f" set-up kNN {pt['knn_s']:.2f} s, calibration "
                           f"{pt['calibrate_s']:.2f} s, reverse graph "
                           f"{pt['reverse_s']:.2f} s, spectral init "
                           f"{pt['spectral_init_s']:.2f} s; {res.n_iters} "
                           f"iterations at "
                           f"{res.times[-1] / res.n_iters * 1e3:.1f} ms each; "
                           f"wall {wall:.1f} s; launches {counts}; PCG "
                           f"iterations {[dg['pcg_iters'] for dg in diags]}")
        say("fit_sharded", f"{kind}: energies "
                           f"{np.array2string(e, precision=8)}")
        say("fit_sharded", f"{kind}: ms an iteration, sharded "
                           f"{np.array2string(np.diff(res.times) * 1e3, precision=1)}"
                           f"; the sparse fit "
                           f"{np.array2string(np.diff(single.result_.times) * 1e3, precision=1)}")
        # the default mu_scale against the single-device fit (same draws)
        gap0 = _rel_gap(e, single.result_.energies)
        # mu_scale = 1e-3: the single-device fit, and the sharded plain path
        # (kernel_impl="torch", no kernel launched)
        mu = SHARDED_CHECK_MU
        kern = _sharded_run(spec, saff, emb.X0_, mesh, 5, mu).energies
        one = Embedding(spec.replace(backend="sparse", max_iters=5,
                                     mu_scale=mu)).fit(
            None, X0=emb.X0_, saff=saff).result_.energies
        sparse_attractive.reset_launch_counts()
        plain = _sharded_run(spec, saff, emb.X0_, mesh, 5, mu,
                             kernel_impl="torch").energies
        if any(sparse_attractive.launch_counts.values()):
            raise AssertionError(f"{kind}: the kernel_impl='torch' sharded "
                                 f"run launched {sparse_attractive.launch_counts}")
        gaps = {"single": _rel_gap(kern, one), "plain": _rel_gap(kern, plain)}
        for gap, limit, what in (
                (gap0, SHARDED_DEFAULT_MU_RTOL,
                 f"the single-device sparse fit, 10 iterations, default "
                 f"mu_scale={spec.mu_scale}"),
                (gaps["single"], 1e-4, f"the single-device sparse fit, 5 "
                                       f"iterations, mu_scale={mu}"),
                (gaps["plain"], 1e-4, f"its kernel_impl='torch' run, 5 "
                                      f"iterations, mu_scale={mu}")):
            if gap > limit:
                raise AssertionError(f"{kind}: the sharded fit against "
                                     f"{what}: max rel diff {gap:.2e} > "
                                     f"{limit:.0e}")
        say("fit_sharded", f"{kind}: max rel energy gap against the "
                           f"single-device sparse fit {gap0:.2e} over 10 "
                           f"iterations at the default mu_scale (limit "
                           f"{SHARDED_DEFAULT_MU_RTOL:.0e}); at mu_scale={mu}"
                           f" over 5: {gaps['single']:.2e} against the "
                           f"single-device fit, {gaps['plain']:.2e} against "
                           f"the sharded kernel_impl='torch' run (no kernel "
                           f"launched), rtol 1e-4 each")
        out["fits"][kind] = emb
        out["traces"][kind] = kern
    return out


def _sharded_rank(rank: int, world: int, store: str, inputs: str,
            out_dir: str) -> None:
    """One rank of phase `fit_sharded_2rank`: a gloo group whose ranks share
    this card, the t-SNE sharded fit from the saved graph and start."""
    from repro_torch.api import EmbedSpec
    from repro_torch.kernels import sparse_attractive
    from repro_torch.launch import make_host_mesh
    from repro_torch.sparse import SparseAffinities, shard_sparse_affinities
    from repro_torch.sparse.graph import NeighborGraph

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        data = torch.load(inputs, map_location="cuda:0", weights_only=False)
        saff = SparseAffinities(NeighborGraph(*data["graph"]),
                                NeighborGraph(*data["rev"]))
        mesh = make_host_mesh()
        spec = EmbedSpec(**data["spec"])
        row0 = shard_sparse_affinities(mesh, ("data",), saff).row0
        sparse_attractive.reset_launch_counts()
        t0 = time.perf_counter()
        res = _sharded_run(spec, saff, data["X0"], mesh, 5, SHARDED_CHECK_MU)
        torch.cuda.synchronize()
        torch.save({"energies": res.energies, "step_sizes": res.step_sizes,
                    "X": res.X.cpu(), "row0": row0,
                    "s_per_iter": res.times[-1] / res.n_iters,
                    "wall": time.perf_counter() - t0,
                    "launches": sparse_attractive.launch_counts[
                        "ell_lap_matvec_local"]},
                   Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_fit_sharded_2rank(sharded: dict) -> None:
    """Two spawned ranks on this one card over gloo (NCCL takes one rank a
    device): the t-SNE sharded fit, five iterations at mu_scale = 1e-3, from
    the one-rank fit's graph and start.  Rank 1 runs the local-rows kernel
    at row0 = 35000; the ranks' results must be bit-identical and equal the
    one-rank trace at rtol 1e-4."""
    import torch.multiprocessing as mp

    emb = sharded["fits"]["tsne"]
    saff = emb.affinities_
    run_dir = SHARDED_DIR / "2rank"
    run_dir.mkdir(parents=True, exist_ok=True)
    for f in run_dir.iterdir():
        f.unlink()
    inputs = run_dir / "inputs.pt"
    torch.save({"graph": tuple(saff.graph), "rev": tuple(saff.rev),
                "X0": emb.X0_, "spec": dataclasses.asdict(emb.spec)}, inputs)
    t0 = time.perf_counter()
    ctx = mp.spawn(_sharded_rank, args=(2, str(run_dir / "store"), str(inputs),
                                  str(run_dir)), nprocs=2, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the 2-rank fit ran past {SPAWN_TIMEOUT_S}"
                                 f" s (a deadlock?)")
    wall = time.perf_counter() - t0
    r0, r1 = (torch.load(run_dir / f"rank{r}.pt", weights_only=False)
              for r in range(2))
    half = -(-N_SPARSE // 2)
    half = -(-half // 8) * 8          # the shard sizing's nb (and rank 1's row0)
    if (r0["row0"], r1["row0"]) != (0, half):
        raise AssertionError(f"row0 {r0['row0']}, {r1['row0']} (want 0, "
                             f"{half})")
    if min(r0["launches"], r1["launches"]) < 1:
        raise AssertionError(f"local-rows kernel launches {r0['launches']}, "
                             f"{r1['launches']}")
    if not (np.array_equal(r0["energies"], r1["energies"])
            and np.array_equal(r0["step_sizes"], r1["step_sizes"])
            and torch.equal(r0["X"], r1["X"])):
        raise AssertionError("the two ranks' results differ")
    gap = _rel_gap(r0["energies"], sharded["traces"]["tsne"])
    if gap > 1e-4:
        raise AssertionError(f"2 ranks against 1: max rel diff {gap:.2e}")
    say("fit_sharded_2rank", f"tsne N={N_SPARSE}, 2 gloo ranks on one card "
                             f"(rows [0, {half}) and [{half}, {N_SPARSE})), 5 "
                             f"iterations at mu_scale={SHARDED_CHECK_MU}: "
                             f"results bit-identical on both ranks; energies "
                             f"within {gap:.2e} of the one-rank fit (rtol "
                             f"1e-4); local-rows launches {r0['launches']} "
                             f"and {r1['launches']}; "
                             f"{r0['s_per_iter'] * 1e3:.1f} ms an iteration "
                             f"(gloo stages each collective through the "
                             f"host); spawn to join {wall:.1f} s")


def _local_laplacian_csr(g, row0: int, nb: int, ws):
    """Rows [row0, row0 + nb) of L = diag(sum_j w_nj) - A as one (nb, n)
    CSR matrix, weights `ws` (the library yardstick)."""
    idx = g.indices[row0:row0 + nb]
    w = ws[row0:row0 + nb]
    k = idx.shape[1]
    rows = torch.arange(nb, device=idx.device)
    r = torch.cat([rows.repeat_interleave(k), rows])
    c = torch.cat([idx.reshape(-1).long(), rows + row0])
    v = torch.cat([-w.reshape(-1), w.sum(-1)])
    return torch.sparse_coo_tensor(torch.stack([r, c]), v, (nb, g.n)
                                   ).coalesce().to_sparse_csr()


def phase_time_ell_local(sharded: dict) -> dict:
    """The local-rows kernel on the EE sharded fit's forward and reverse
    graphs and embedding, at nb = 35000 (row0 = 35000, a 2-rank shard) and
    nb = 70000 (the one rank here), float32 and bfloat16: device time by
    CUDA-graph replay, eager time, the byte bound (idx and w of the nb rows,
    X once, the output), the plain version and torch.sparse.mm on the
    shard's CSR Laplacian rows, each call held against the float64 plain
    version.  Then the NCCL all-gather of the (N, d) slab that follows the
    products in every CG matvec (`_replicate_rows`), beside an all_reduce
    of the zero-filled slab, which gives the same bits."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_attractive import ell_lap_matvec_local_cuda

    emb = sharded["fits"]["ee"]
    X = emb.embedding_
    n, d = X.shape
    out = {}
    for gname, g in (("forward", emb.affinities_.graph),
                     ("reverse", emb.affinities_.rev)):
        k = g.k
        for row0, nb in ((N_SPARSE // 2, N_SPARSE // 2), (0, N_SPARSE)):
            rows = slice(row0, row0 + nb)
            idx = g.indices[rows].clone()
            want64 = ell_plain64(X, g.indices, g.weights, "float32")[rows]
            for storage, size in (("float32", 4), ("bfloat16", 2)):
                Xs = ops.to_storage(X, storage)
                ws = ops.to_storage(g.weights, storage)
                w = ws[rows].clone()
                nbytes = nb * k * (4 + size) + n * d * size + nb * d * 4
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = 3 * nb * k * d / PEAK_F32_FLOPS * 1e3
                bound_ms = max(t_bytes, t_ops)
                want = (want64 if storage == "float32" else
                        ell_plain64(X, g.indices, g.weights, storage)[rows])
                X64 = Xs.double()
                w64 = w.double().abs()
                mass = (w64.sum(-1, keepdim=True) * X64[rows].abs()
                        + torch.einsum("nk,nkd->nd", w64, X64[idx].abs()))
                plain_ms = cuda_ms(lambda: ops.ell_lap_matvec_local(
                    Xs, idx, w, row0, impl="torch"), reps=10)
                csr = _local_laplacian_csr(g, row0, nb, ws)
                lib_ms = cuda_ms(lambda: torch.sparse.mm(csr, Xs), reps=50)
                lib_err = float((torch.sparse.mm(csr, Xs).double()
                                 - want).abs().max())
                del csr

                def call():
                    return ell_lap_matvec_local_cuda(Xs, idx, w, row0)
                ms = graph_ms(call)
                eager_ms = cuda_ms(call, reps=200)
                try:
                    err, ratio = ell_compare(call(), want, mass)
                except AssertionError as e:
                    raise AssertionError(
                        f"local ELL != plain on the {gname} graph row0="
                        f"{row0} nb={nb} {storage}: {e}") from None
                out[gname, nb, storage] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations",
                    "library_ms": lib_ms, "max_abs_err": err}
                say("time_ell_local", f"ee {gname} graph (k={k}, d={d}) rows "
                                      f"[{row0}, {row0 + nb}) {storage}: "
                                      f"kernel {ms * 1e3:.1f} us on the "
                                      f"device ({bound_ms / ms * 100:.0f}% of"
                                      f" the {nbytes / 1e6:.1f} MB bound "
                                      f"{bound_ms * 1e3:.1f} us; "
                                      f"{eager_ms * 1e3:.1f} us a call issued"
                                      f" eagerly), plain "
                                      f"{plain_ms * 1e3:.1f} us, "
                                      f"torch.sparse.mm CSR rows "
                                      f"{lib_ms * 1e3:.1f} us (its err "
                                      f"{lib_err:.2e}); max abs err "
                                      f"{err:.2e} at {ratio:.2f} of its "
                                      f"bound")
                say("time_ell_local", f"  {_gather_line(nb, k, w, ms)}")
    from repro_torch.sparse.sharding import (_replicate_rows,
                                             shard_sparse_affinities)

    mesh = sharded["mesh"]
    sg = shard_sparse_affinities(mesh, ("data",), emb.affinities_)
    n_pad = sg.n_pad
    local = torch.cat([X, X.new_zeros((n_pad - n, d))])[sg.row0:][
        :sg.indices.shape[0]].contiguous()
    ag_ms = cuda_ms(lambda: _replicate_rows(mesh, local, n_pad), reps=50)

    def zero_fill_all_reduce():
        slab = local.new_zeros((n_pad, d))
        slab[:local.shape[0]] = local
        dist.all_reduce(slab, group=mesh.group)
    ar_ms = cuda_ms(zero_fill_all_reduce, reps=50)
    out["all_gather_ms"], out["all_reduce_ms"] = ag_ms, ar_ms
    say("time_ell_local", f"re-replicating the ({n_pad}, {d}) float32 slab, "
                          f"{mesh.size} NCCL rank(s), a call issued eagerly: "
                          f"all_gather_into_tensor {ag_ms * 1e3:.1f} us; a "
                          f"zero-filled slab's all_reduce "
                          f"{ar_ms * 1e3:.1f} us")
    return out


AUTOTUNE_DIR = ROOT / "build" / "chip_smoke_autotune"   # git-ignored
GUARD_ITERS = 3      # guarded iterations of each warmed fit


def _outputs(out) -> tuple:
    """A wrapper's outputs as a flat tuple of tensors."""
    if isinstance(out, torch.Tensor):
        return (out,)
    if hasattr(out, "la_x"):
        return (out.la_x, out.lb_x, out.e_plus, out.s)
    return tuple(out)


def _tune_case(tag: str, name: str, key: tuple, dispatch, launch,
               cands) -> dict:
    """One main-path shape: the dispatch's search (its candidates' times,
    the pick and the seconds it took) or cache hit, a second lookup (a
    hit), every candidate's outputs bit-equal to the fixed shape's, and the
    pick against the fixed shape by CUDA-graph replay in turns (fixed,
    pick, pick, fixed)."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels.autotune import KernelConfig

    kernel, n, k, d, storage = key
    ckey = autotune.cache_key(kernel, n=n, k=k, d=d, dtype=storage)
    before = autotune.n_searches
    t0 = time.perf_counter()
    dispatch()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rec = dict(ops.last_dispatch(name))
    searched = autotune.n_searches > before
    if not rec.get("autotuned") or rec["cache_hit"] == searched:
        raise AssertionError(f"autotune {tag}: dispatch record {rec} after "
                             f"{'a search' if searched else 'no search'}")
    dispatch()
    if not ops.last_dispatch(name)["cache_hit"]:
        raise AssertionError(f"autotune {tag}: the second lookup searched "
                             f"again: {ops.last_dispatch(name)}")
    pick = KernelConfig(block_rows=rec["block_rows"],
                        block_cols=rec.get("block_cols", 0),
                        layout=cands[0].layout, chunk=rec.get("chunk", 0))
    if pick not in cands:
        raise AssertionError(f"autotune {tag}: pick {pick} is no candidate")
    fixed = _outputs(launch(None))
    for cfg in cands:
        got = _outputs(launch(cfg))
        if not all(torch.equal(a, b) for a, b in zip(got, fixed)):
            raise AssertionError(f"autotune {tag}: candidate {cfg} is not "
                                 f"bit-equal to the fixed shape")
    reps = 20 if kernel.startswith("pairwise") else 50
    f1 = graph_ms(lambda: launch(None), reps=reps, replays=3)
    p1 = graph_ms(lambda: launch(pick), reps=reps, replays=3)
    p2 = graph_ms(lambda: launch(pick), reps=reps, replays=3)
    f2 = graph_ms(lambda: launch(None), reps=reps, replays=3)
    log = autotune.search_log[ckey]

    def shape(c):
        c = KernelConfig.from_json(c) if isinstance(c, dict) else c
        return (f"{c.block_rows}" + (f"x{c.block_cols}" if c.block_cols
                                     else "")
                + (f"/{c.chunk}" if c.chunk else ""))

    times = " ".join(f"{shape(c)}:{t * 1e6:.1f}" for c, t in log["timings"])
    say("autotune", f"{tag}: {'searched' if searched else 'cache hit'} "
                    f"({first_s:.3f} s first call); search "
                    f"{log['seconds']:.3f} s, candidates us "
                    f"(rows[xcols][/chunk]) {times}; pick {shape(pick)}, "
                    f"fixed {shape(cands[0])}; by replay pick "
                    f"{p1 * 1e3:.1f} / {p2 * 1e3:.1f} us, fixed "
                    f"{f1 * 1e3:.1f} / {f2 * 1e3:.1f} us; all "
                    f"{len(cands)} candidates bit-equal to the fixed shape")
    return {"tag": tag, "key": list(key), "pick": pick.to_json(),
            "fixed": cands[0].to_json(), "searched": searched,
            "search_s": log["seconds"], "pick_us": [p1 * 1e3, p2 * 1e3],
            "fixed_us": [f1 * 1e3, f2 * 1e3]}


def _autotune_cases(dense_data: dict, sparse_fits: dict, sharded: dict,
                    tree_fits: dict) -> list:
    """(tag, record name, key, dispatch, launch(cfg or None), candidates)
    for every kernel at every main-path shape, float32 and bfloat16."""
    from repro_torch.kernels import autotune, farfield, ops
    from repro_torch.kernels.pairwise import pairwise_terms_cuda
    from repro_torch.kernels.sparse_attractive import (
        ell_lap_matvec_cuda, ell_lap_matvec_local_cuda)
    from repro_torch.sparse import farfield as ff

    def shape(cfg, *fields):
        return {} if cfg is None else {f: getattr(cfg, f) for f in fields}

    cases = []
    for storage in ("float32", "bfloat16"):
        for kind in ("ee", "tsne"):
            X, Wp, Wm = dense_data[kind]
            Xs, Wps, Wms = (ops.to_storage(t, storage) for t in (X, Wp, Wm))
            n, d = X.shape
            cases.append((
                f"pairwise {kind} N={n} {storage}", "pairwise_terms",
                (f"pairwise.{kind}", n, 0, d, storage),
                functools.partial(ops.pairwise_terms, Xs, Wps, Wms, kind,
                                  storage_dtype=storage),
                lambda cfg, a=(Xs, Wps, Wms, kind): pairwise_terms_cuda(
                    *a, **shape(cfg, "block_rows", "block_cols")),
                autotune.pairwise_candidates(d=d)))
    emb = sparse_fits["ee"]
    X = emb.embedding_
    n, d = X.shape
    for layout in ELL_LAYOUTS:
        for gname, g in (("forward", emb.affinities_.graph),
                         ("reverse", emb.affinities_.rev)):
            for storage in ("float32", "bfloat16"):
                Xs = ops.to_storage(X, storage)
                ws = ops.to_storage(g.weights, storage)
                cases.append((
                    f"ell {layout} {gname} k={g.k} N={n} {storage}",
                    "ell_lap_matvec",
                    ("ell" if layout == "vmem" else "ell_hbm", n, g.k, d,
                     storage),
                    functools.partial(ops.ell_lap_matvec, Xs, g.indices, ws,
                                      layout=layout, storage_dtype=storage),
                    lambda cfg, a=(Xs, g.indices, ws), lay=layout:
                        ell_lap_matvec_cuda(*a, layout=lay,
                                            **shape(cfg, "block_rows",
                                                    "chunk")),
                    autotune.ell_candidates(k=g.k, layouts=[layout])))
    emb = sharded["fits"]["ee"]
    X = emb.embedding_
    for gname, g in (("forward", emb.affinities_.graph),
                     ("reverse", emb.affinities_.rev)):
        for row0, nb in ((0, N_SPARSE), (N_SPARSE // 2, N_SPARSE // 2)):
            rows = slice(row0, row0 + nb)
            for storage in ("float32", "bfloat16"):
                Xs = ops.to_storage(X, storage)
                idx = g.indices[rows].clone()
                ws = ops.to_storage(g.weights, storage)[rows].clone()
                cases.append((
                    f"ell_local {gname} k={g.k} nb={nb} row0={row0} "
                    f"{storage}", "ell_lap_matvec_local",
                    ("ell_local", nb, g.k, d, storage),
                    functools.partial(ops.ell_lap_matvec_local, Xs, idx, ws,
                                      row0, storage=storage),
                    lambda cfg, a=(Xs, idx, ws, row0):
                        ell_lap_matvec_local_cuda(
                            *a, **shape(cfg, "block_rows", "chunk")),
                    autotune.ell_candidates(k=g.k, layouts=["vmem"])))
    emb = tree_fits["tsne"]
    X = emb.embedding_
    plan = ff.make_grid_plan(X.shape[0], theta=emb.spec.theta)
    grid = ff._grid_state(X, plan)
    for storage in ("float32", "bfloat16"):
        g = dataclasses.replace(
            grid, Xs=ops.to_storage(grid.Xs, storage),
            res_com=ops.to_storage(grid.res_com, storage),
            level_com=tuple(ops.to_storage(c, storage)
                            for c in grid.level_com))
        packed = farfield.pack_tree(g)
        cases.append((
            f"bh_tree tsne N={X.shape[0]} depth={plan.depth} {storage}",
            "bh_tree",
            ("bh_tree.tsne", X.shape[0], ops._tree_slots(grid), 2, storage),
            functools.partial(ops.bh_tree, grid, "tsne",
                              storage_dtype=storage),
            lambda cfg, a=packed: farfield.launch_tree(
                a, "tsne", **shape(cfg, "block_rows")),
            autotune.bh_tree_candidates()))
    return cases


class _Warmed:
    """An objective whose direction solver was set up once, outside the
    guards (SD's Cholesky factor waits on the card by design)."""

    def __init__(self, obj):
        self._obj = obj
        self._solver = obj.make_direction_solver()

    def __getattr__(self, name):
        return getattr(self._obj, name)

    def make_direction_solver(self):
        return self._solver


def _guarded_fit(tag: str, obj, X, spec) -> None:
    """GUARD_ITERS iterations of a warmed objective through the engine,
    after one warm-up iteration: first with the sync-debug mode at "warn"
    (every unsanctioned host wait listed by file and line), then under
    `assert_compile_count(expected=0)` and `no_implicit_transfers()`."""
    import traceback
    import warnings

    from repro_torch.analysis import assert_compile_count, no_implicit_transfers
    from repro_torch.embed.engine import fit_loop, make_loop_config

    cfg = dataclasses.replace(make_loop_config(spec, spec.resolved_ls()),
                              max_iters=GUARD_ITERS, tol=0.0,
                              checkpoint_dir=None, max_seconds=None)
    fit_loop(obj, X, dataclasses.replace(cfg, max_iters=1))     # warm-up
    torch.cuda.synchronize()
    sites = set()

    def note(message, category, filename, lineno, file=None, line=None):
        # the port's frames above the waiting call, innermost first (the
        # mode's own "prototype feature" notice is not a wait)
        if "called a synchronizing" in str(message):
            frames = [f"{Path(f.filename).name}:{f.lineno}"
                      for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename]
            sites.add(" < ".join([f"{Path(filename).name}:{lineno}",
                                  *frames[::-1][:4]]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        with no_implicit_transfers(mode="warn"):
            fit_loop(obj, X, cfg)
    sites = sorted(sites)
    if sites:
        raise AssertionError(f"autotune guard {tag}: unsanctioned host "
                             f"waits at {'; '.join(sites)}")
    t0 = time.perf_counter()
    with assert_compile_count(expected=0, label=tag) as counter, \
            no_implicit_transfers():
        res = fit_loop(obj, X, cfg)
    torch.cuda.synchronize()
    if not np.all(np.isfinite(res.energies)):
        raise AssertionError(f"autotune guard {tag}: energies {res.energies}")
    say("autotune", f"guard {tag}: {res.n_iters} warmed iterations under "
                    f"assert_compile_count(expected=0) and "
                    f"no_implicit_transfers(): {counter.count} builds or "
                    f"searches, no unsanctioned host wait (warn pass: none "
                    f"listed); {(time.perf_counter() - t0) * 1e3:.1f} ms")


def phase_autotune(dense_data: dict, dense_spec, sparse_fits: dict,
                   sharded: dict, tree_fits: dict) -> dict:
    """The launch-shape autotuner (kernels/autotune.py) at every main-path
    shape, with its disk cache under the ignored build/chip_smoke_autotune/
    (REPRO_AUTOTUNE_CACHE): each search's candidates and pick, every
    candidate bit-equal to the fixed shape, the pick against the fixed shape
    by CUDA-graph replay, a second lookup and a fresh process hitting the
    cache; then the warmed dense SD, sparse and sharded fits under the
    compile-count and sync guards."""
    import os

    from repro_torch.api.registries import strategy_entry
    from repro_torch.core.affinities import Affinities
    from repro_torch.core.minimize import DenseObjective
    from repro_torch.embed.trainer import build_sparse_objective
    from repro_torch.kernels import autotune

    AUTOTUNE_DIR.mkdir(parents=True, exist_ok=True)
    cache = AUTOTUNE_DIR / "autotune.json"
    cache.unlink(missing_ok=True)
    os.environ[autotune.CACHE_ENV] = str(cache)
    autotune.clear_cache()
    say("autotune", f"device kind {autotune.device_kind()}; cache {cache}; "
                    f"searches so far in this run {autotune.n_searches}, "
                    f"their launches (apart from launch_counts) "
                    f"{dict(autotune.search_launches)}")
    results = []
    try:
        for case in _autotune_cases(dense_data, sparse_fits, sharded,
                                    tree_fits):
            results.append(_tune_case(*case))
    finally:
        del os.environ[autotune.CACHE_ENV]
    # a fresh process on the same file finds every pick without a search
    keys = [r["key"] for r in results]
    code = (
        "import json, sys, torch\n"
        "from repro_torch.kernels import autotune\n"
        "def boom(cfg, b):\n"
        "    raise AssertionError('searched')\n"
        "out = []\n"
        "for kernel, n, k, d, dtype in json.loads(sys.argv[1]):\n"
        "    cfg, hit = autotune.get_config(kernel, n=n, k=k, d=d,\n"
        "        dtype=dtype, candidates=[autotune.KernelConfig(1)],\n"
        "        runner=boom)\n"
        "    out.append([cfg.to_json(), hit])\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env[autotune.CACHE_ENV] = str(cache)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(keys)],
                          env=env, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"autotune: the fresh process failed:\n"
                             f"{proc.stderr[-4000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    for r, (cfg, hit) in zip(results, fresh):
        if not hit or cfg != r["pick"]:
            raise AssertionError(f"autotune {r['tag']}: the fresh process "
                                 f"got {cfg} (hit {hit}), not {r['pick']}")
    n_keys = len(json.loads(cache.read_text())["entries"])
    say("autotune", f"a fresh process on {cache.name} ({n_keys} entries) "
                    f"hit the cache for all {len(fresh)} shapes, same picks")

    # the warmed fits under the guards
    X, Wp, Wm = dense_data["ee"]
    spec = dense_spec
    strategy = strategy_entry(spec.strategy).dense_factory(
        spec, **dict(spec.strategy_opts))
    lam = torch.tensor(spec.lam, dtype=X.dtype, device=X.device)
    dense = DenseObjective(Affinities(Wp, Wm), spec.kind, lam, strategy,
                           spec.resolved_ls(), X, impl=spec.kernel_args())
    _guarded_fit("dense SD EE N=20000", _Warmed(dense), X, spec)
    del dense
    torch.cuda.empty_cache()
    emb = sparse_fits["tsne"]
    obj, X0, _ = build_sparse_objective(
        emb.spec, None, emb.embedding_, strategy=emb.spec.strategy,
        saff=emb.affinities_, device=emb.embedding_.device)
    _guarded_fit("sparse t-SNE N=70000", _Warmed(obj), X0, emb.spec)
    emb = sharded["fits"]["tsne"]
    obj, X0, _ = build_sparse_objective(
        emb.spec, None, emb.embedding_, strategy=emb.spec.strategy,
        sharded=True, saff=emb.affinities_, device=emb.embedding_.device,
        mesh=sharded["mesh"])
    _guarded_fit("sparse-sharded t-SNE N=70000 (one NCCL rank)",
                 _Warmed(obj), X0, emb.spec)
    return {r["tag"]: r for r in results}


def tuned_numbers(tuned: dict, tag: str | None) -> dict:
    """The kernels line's launch-shape keys for a kernel at its row's shape:
    the autotuned pick (phase autotune) and its device time by replay (the
    mean of the two turns), beside `ms`, the fixed shape's."""
    if tag is None:
        return {"tuned_shape": None, "tuned_ms": None}
    r = tuned[tag]
    return {"tuned_shape": r["pick"], "tuned_ms": sum(r["pick_us"]) / 2e3}


def phase_profile_sharded(emb, mesh, iters: int = 3) -> None:
    """Where a sharded SD iteration's time goes: `iters` iterations of the
    one-rank t-SNE sharded fit, continued from its embedding, under
    torch.profiler: device time by kernel, the idle share, and the NCCL
    collectives' time a CG matvec."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec, X = emb.spec, emb.embedding_

    def run(n_iters):
        return _sharded_run(spec, emb.affinities_, X, mesh, n_iters,
                            spec.mu_scale)

    run(1)                                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(iters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        say("profile_sharded", "torch.profiler recorded no device kernels: "
                               "device time and idle share not measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    say("profile_sharded", f"{spec.kind} N={X.shape[0]}, {mesh.size} NCCL "
                           f"rank(s): {iters} sharded SD iterations (+ the "
                           f"initial evaluation; {int(res.n_fevals[-1])} "
                           f"energy evaluations) in {wall * 1e3:.1f} ms wall;"
                           f" device busy {busy * 1e3:.1f} ms, idle share "
                           f"{max(0.0, 1 - busy / wall):.2f}")
    for dev_us, key, count in rows[:10]:
        say("profile_sharded", f"  {dev_us / 1e3 / iters:8.3f} ms/iteration "
                               f"{count / iters:7.1f} calls/iteration  "
                               f"{key[:80]}")
    for label, tag in (("the local-rows kernel (ell_gather_local)",
                        "ell_gather_local"), ("NCCL", "nccl")):
        hit = [(us, c) for us, key, c in rows if tag in key.lower()]
        us, calls = sum(r[0] for r in hit), sum(r[1] for r in hit)
        say("profile_sharded", f"  {label}: {us / 1e3 / iters:.3f} "
                               f"ms/iteration, {calls / iters:.1f} "
                               f"calls/iteration, {us / max(calls, 1):.1f} "
                               f"us a call")
    matvecs = sum(c for _, key, c in rows if "ell_gather_local" in key) / 2
    nccl = sum(us for us, key, _ in rows if "nccl" in key.lower())
    if nccl:
        say("profile_sharded", f"  NCCL device time per CG matvec or "
                               f"gradient (one slab all-gather each, "
                               f"{matvecs:.0f} of them, plus one 2-scalar "
                               f"reduction an evaluation): "
                               f"{nccl / max(matvecs, 1):.1f} us")
    else:
        say("profile_sharded", f"  no NCCL kernel recorded over "
                               f"{matvecs:.0f} CG matvecs and gradients: "
                               f"with {mesh.size} rank(s) the collectives "
                               f"launch none; their host time a call is "
                               f"phase time_ell_local's")


# -- slice 5, dense half: the 2-D-sharded dense-mesh backend -----------------

MESH_FITS = (("sd", "ee", 100.0, 10), ("sd", "tsne", 1.0, 10),
             ("fp", "ee", 100.0, 5), ("gd", "ee", 100.0, 5))
N_MESH_4RANK = 2048   # the largest N for which backend="auto" picks it
#: three: the 4-rank checks are the ranks' agreement, which three show, and
#: the spawn, not the iterations, sets the phase's time
MESH_4RANK_ITERS = 3
MESH_DIR = ROOT / "build" / "chip_smoke_dense_mesh"   # git-ignored


def _mesh_eg(mesh, X, Wp, kind: str, lam: float, with_grad: bool = True):
    """The mesh tile's (E, G) at X, G replicated (E alone without grad)."""
    from repro_torch.embed.distributed import (default_mesh_spec,
                                               make_distributed_energy_grad,
                                               replicate, shard_pairwise)
    spec = default_mesh_spec(mesh)
    eg = make_distributed_energy_grad(mesh, spec, kind, unit_wm=True)
    tile = shard_pairwise(mesh, spec, Wp)
    lam = torch.tensor(lam, dtype=torch.float32, device=X.device)
    if not with_grad:
        return eg(X, tile, lam, with_grad=False)
    E, G = eg(X, tile, lam)
    return E, replicate(mesh, G, spec)


def phase_fit_dense_mesh(dense: dict, starts: dict, mesh) -> dict:
    """The dense half of slice 5: `Embedding(EmbedSpec(backend="dense-mesh"),
    mesh=make_host_mesh())` in the one-rank NCCL group of phase fit_sharded,
    on phase fit's N = 20000 data from its spectral starts: SD on EE
    (lambda = 100) and t-SNE (lambda = 1), ten iterations; FP and GD on EE,
    five.  The tile is plain torch (no pairwise kernel launch); energies
    must not rise.  Then the tile's (E, G) at phase fit's settled EE
    embedding against kernel 1 through `core.energy_and_grad`, and both
    timed on the same X and Wp."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.core import energy_and_grad, make_affinities
    from repro_torch.kernels import pairwise
    from repro_torch.kernels.pairwise import pairwise_terms_cuda

    Y = dense["Y"]
    n = Y.shape[0]
    out = {"fits": {}}
    for strategy, kind, lam, iters in MESH_FITS:
        spec = EmbedSpec(kind=kind, lam=lam, perplexity=30.0,
                         backend="dense-mesh", strategy=strategy,
                         max_iters=iters, tol=0.0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pairwise.reset_launch_counts()
        t0 = time.perf_counter()
        emb = Embedding(spec, mesh=mesh).fit(Y, X0=starts[kind])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        res = emb.result_
        e = res.energies
        tag = f"{strategy} {kind} lambda={lam:g}"
        if emb.backend_ != "dense-mesh":
            raise AssertionError(f"{tag}: backend {emb.backend_!r}")
        if pairwise.launch_counts["pairwise_terms"]:
            raise AssertionError(f"{tag}: the mesh fit launched the pairwise"
                                 f" kernel {dict(pairwise.launch_counts)}")
        if not np.all(np.isfinite(e)) or np.any(np.diff(e) > 0):
            raise AssertionError(f"{tag}: energies {e}")
        X = emb.embedding_
        if tuple(X.shape) != (n, 2) or not bool(torch.isfinite(X).all()):
            raise AssertionError(f"{tag}: bad embedding {tuple(X.shape)}")
        evals = (res.n_fevals[-1] - 1) / res.n_iters
        setup = " (the block-Jacobi factor)" if strategy == "sd" else ""
        say("fit_dense_mesh", f"{tag}: N={n}, mesh {mesh.shape}, resolved "
                              f"backend {emb.backend_}; set-up affinities "
                              f"{res.phase_times['affinities_s']:.2f} s, "
                              f"direction set-up{setup} "
                              f"{res.setup_time:.3f} s; {res.n_iters} "
                              f"iterations at "
                              f"{res.times[-1] / res.n_iters * 1e3:.1f} ms "
                              f"each, {evals:.2f} energy evaluations an "
                              f"iteration; pairwise kernel launches 0; peak "
                              f"device memory {peak / 1e9:.2f} GB; wall "
                              f"{wall:.1f} s")
        say("fit_dense_mesh", f"{tag}: energies "
                              f"{np.array2string(e, precision=8)}")
        out["fits"][strategy, kind] = {"spec": spec, "energies": e,
                                       "X": X.cpu()}
        del emb
    # the tile against kernel 1 at phase fit's settled EE embedding
    X = dense["X"].cuda().contiguous()
    lam = 100.0
    aff = make_affinities(torch.as_tensor(Y, device="cuda"), 30.0,
                          model="ee")
    E1, G1 = _mesh_eg(mesh, X, aff.Wp, "ee", lam)
    pairwise.reset_launch_counts()
    E2, G2 = energy_and_grad(X, aff, "ee", torch.tensor(lam, device="cuda"))
    if pairwise.launch_counts["pairwise_terms"] != 1:
        raise AssertionError(f"kernel 1's evaluation launched "
                             f"{dict(pairwise.launch_counts)}")
    e_rel = abs(float(E1) - float(E2)) / abs(float(E2))
    g_rel = float(torch.linalg.norm(G1 - G2) / torch.linalg.norm(G2))
    if e_rel > 1e-4 or g_rel > 1e-4:
        raise AssertionError(f"the mesh tile against kernel 1: E rel "
                             f"{e_rel:.2e}, G rel {g_rel:.2e} (limit 1e-4)")
    say("fit_dense_mesh", f"the mesh tile's (E, G) at phase fit's settled EE "
                          f"embedding against kernel 1 through "
                          f"core.energy_and_grad: E rel {e_rel:.2e}, G rel "
                          f"{g_rel:.2e} in norm (limit 1e-4 each)")
    tile_ms = cuda_ms(lambda: _mesh_eg(mesh, X, aff.Wp, "ee", lam), reps=5)
    tile_e_ms = cuda_ms(lambda: _mesh_eg(mesh, X, aff.Wp, "ee", lam,
                                         with_grad=False), reps=5)
    k1_ms = graph_ms(lambda: pairwise_terms_cuda(X, aff.Wp, aff.Wm, "ee"),
                     reps=20)
    k1_eager = cuda_ms(lambda: pairwise_terms_cuda(X, aff.Wp, aff.Wm, "ee"),
                       reps=20)
    say("fit_dense_mesh", f"ms an evaluation at N={n}, EE, the same X and Wp:"
                          f" the plain-torch mesh tile {tile_ms:.3f} ms with "
                          f"the gradient, {tile_e_ms:.3f} ms the energy alone"
                          f" (CUDA events, eager); kernel 1 {k1_ms:.3f} ms "
                          f"on the device (CUDA-graph replay; "
                          f"{k1_eager:.3f} ms a call issued eagerly); "
                          f"{tile_ms / k1_ms:.1f}x")
    out["tile"] = {"ms": tile_ms, "energy_ms": tile_e_ms, "k1_ms": k1_ms}
    del aff, G1, G2
    torch.cuda.empty_cache()
    return out


def _dense_mesh_rank(rank: int, world: int, store: str, inputs: str,
                     out_dir: str) -> None:
    """One rank of phase `fit_dense_mesh_4rank`: a gloo group whose ranks
    share this card on a (2, 2) mesh, the mesh's (E, G) at the start and
    the `backend="auto"` SD fits from it."""
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.core import make_affinities
    from repro_torch.kernels import pairwise
    from repro_torch.launch import make_host_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        data = torch.load(inputs, map_location="cuda:0", weights_only=False)
        mesh = make_host_mesh(model_axis=2)
        out = {"coords": mesh.coords, "fits": {}, "eg": {}}
        Y = data["Y"]
        for kind, fields in data["specs"].items():
            aff = make_affinities(torch.as_tensor(Y, device="cuda"), 30.0,
                                  model=kind)
            E, G = _mesh_eg(mesh, data["X0"][kind], aff.Wp, kind,
                            fields["lam"])
            out["eg"][kind] = (float(E), G.cpu())
            del aff
            pairwise.reset_launch_counts()
            t0 = time.perf_counter()
            emb = Embedding(EmbedSpec(**fields), mesh=mesh).fit(
                Y, X0=data["X0"][kind])
            torch.cuda.synchronize()
            res = emb.result_
            out["fits"][kind] = {
                "backend": emb.backend_, "energies": res.energies,
                "step_sizes": res.step_sizes, "X": emb.embedding_.cpu(),
                "s_per_iter": res.times[-1] / res.n_iters,
                "wall": time.perf_counter() - t0,
                "launches": pairwise.launch_counts["pairwise_terms"]}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_fit_dense_mesh_4rank(mesh) -> None:
    """Four spawned gloo ranks on this card on a (2, 2) ("data", "model")
    mesh: N = 2048 `mnist_like`, `backend="auto"` (which must resolve to
    dense-mesh), SD on EE (lambda = 100) and t-SNE (lambda = 1), three
    iterations from the spectral start.  The four ranks' X and traces must
    be bit-equal, and the (2, 2) mesh's (E, G) at the start equal the
    one-rank mesh's at rtol 1e-5."""
    import torch.multiprocessing as mp

    from repro_torch.core import make_affinities
    from repro_torch.core.spectral_init import laplacian_eigenmaps
    from repro_torch.data import mnist_like

    n = N_MESH_4RANK
    Y, _ = mnist_like(n=n, dim=784, seed=0)
    specs = {"ee": dict(kind="ee", lam=100.0, perplexity=30.0,
                        strategy="sd", max_iters=MESH_4RANK_ITERS, tol=0.0),
             "tsne": dict(kind="tsne", lam=1.0, perplexity=30.0,
                          strategy="sd", max_iters=MESH_4RANK_ITERS,
                          tol=0.0)}
    X0, one = {}, {}
    for kind, fields in specs.items():
        aff = make_affinities(torch.as_tensor(Y, device="cuda"), 30.0,
                              model=kind)
        X0[kind] = laplacian_eigenmaps(aff.Wp, 2) * 0.1
        one[kind] = _mesh_eg(mesh, X0[kind], aff.Wp, kind, fields["lam"])
    run_dir = MESH_DIR / "4rank"
    run_dir.mkdir(parents=True, exist_ok=True)
    for f in run_dir.iterdir():
        f.unlink()
    inputs = run_dir / "inputs.pt"
    torch.save({"Y": Y, "X0": X0, "specs": specs}, inputs)
    t0 = time.perf_counter()
    ctx = mp.spawn(_dense_mesh_rank, args=(4, str(run_dir / "store"),
                                           str(inputs), str(run_dir)),
                   nprocs=4, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the 4-rank fit ran past {SPAWN_TIMEOUT_S}"
                                 f" s (a deadlock?)")
    wall = time.perf_counter() - t0
    ranks = [torch.load(run_dir / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    coords = [tuple(r["coords"].values()) for r in ranks]
    if coords != [(0, 0), (0, 1), (1, 0), (1, 1)]:
        raise AssertionError(f"rank coordinates {coords}")
    for kind in specs:
        fits = [r["fits"][kind] for r in ranks]
        for f in fits:
            if f["backend"] != "dense-mesh" or f["launches"]:
                raise AssertionError(f"{kind}: backend {f['backend']!r}, "
                                     f"pairwise launches {f['launches']}")
            e = f["energies"]
            if not np.all(np.isfinite(e)) or np.any(np.diff(e) > 0):
                raise AssertionError(f"{kind}: energies {e}")
        for f in fits[1:]:
            if not (np.array_equal(f["energies"], fits[0]["energies"])
                    and np.array_equal(f["step_sizes"],
                                       fits[0]["step_sizes"])
                    and torch.equal(f["X"], fits[0]["X"])):
                raise AssertionError(f"{kind}: the four ranks' fits differ")
        E1, G1 = (float(one[kind][0]), one[kind][1].cpu())
        worst = 0.0
        for r in ranks:
            E4, G4 = r["eg"][kind]
            e_rel = abs(E4 - E1) / abs(E1)
            g_rel = float(torch.linalg.norm(G4 - G1) / torch.linalg.norm(G1))
            worst = max(worst, e_rel, g_rel)
        if worst > 1e-5:
            raise AssertionError(f"{kind}: the (2, 2) mesh's (E, G) at X0 "
                                 f"against the one-rank mesh's: {worst:.2e}")
        f = fits[0]
        say("fit_dense_mesh_4rank", f"{kind} N={n}, 4 gloo ranks on one card "
                                    f"on a (2, 2) mesh: backend='auto' "
                                    f"resolved to dense-mesh on every rank; "
                                    f"(E, G) at X0 within {worst:.2e} of the "
                                    f"one-rank mesh's (rtol 1e-5); "
                                    f"{MESH_4RANK_ITERS} SD iterations "
                                    f"bit-identical on all four ranks, "
                                    f"{f['s_per_iter'] * 1e3:.1f} ms an "
                                    f"iteration (gloo stages each collective"
                                    f" through the host); energies "
                                    f"{np.array2string(f['energies'], precision=8)}")
    say("fit_dense_mesh_4rank", f"spawn to join {wall:.1f} s")


# -- slice 6: run telemetry and checkpoint/resume -----------------------------

TEL_PHASES = ("graph-build", "spectral-init", "setup", "compile")
TEL_STEPS = ("graph-build/knn", "graph-build/calibrate",
             "graph-build/reverse")
TEL_BUDGET = 0.05      # the reference's telemetry overhead budget (printed)
RESUME_DIR = ROOT / "build" / "chip_smoke_resume"    # git-ignored


def _iter_ms(res) -> float:
    """Median milliseconds an iteration of an engine result."""
    return float(np.median(np.diff(res.times))) * 1e3


def _held_equal(tag: str, got, want, what: str) -> None:
    if isinstance(got, torch.Tensor):
        same = torch.equal(got.cpu(), want.cpu())
    else:
        same = np.array_equal(np.asarray(got), np.asarray(want))
    if not same:
        raise AssertionError(f"{tag}: {what} not bit-equal: {got} vs {want}")


def phase_telemetry(sparse: dict) -> dict:
    """Slice 6's telemetry path: the sparse t-SNE fit of phase fit_sparse
    again from Y with `fit(telemetry=<dir>)` (module docstring, phase
    19)."""
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Embedding
    from repro_torch.kernels import ops, sparse_attractive
    from repro_torch.obs import Telemetry, load_jsonl
    from repro_torch.obs import report

    ref = sparse["fits"]["tsne"]
    spec = ref.spec
    default = ops.ELL_DEFAULT_LAYOUT
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        sparse_attractive.reset_launch_counts()
        t0 = time.perf_counter()
        emb = Embedding(spec).fit(sparse["Y"], telemetry=d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sparse_attractive.launch_counts)
        if launches[f"ell_lap_matvec_{default}"] < 1:
            raise AssertionError(f"telemetry fit: ELL launches {launches}")
        res = emb.result_
        _held_equal("telemetry", res.energies, ref.result_.energies,
                    "energies with and without telemetry")
        _held_equal("telemetry", emb.embedding_, ref.embedding_,
                    "X with and without telemetry")
        meta, phases, records = load_jsonl(f"{d}/run.jsonl")
        if [r.it for r in records] != list(range(1, spec.max_iters + 1)):
            raise AssertionError(f"iteration records {[r.it for r in records]}")
        for r in records:
            x = r.extras
            if not (x.get("pcg_iters", 0) >= 1 and "pcg_residual" in x
                    and x.get("z_ema", 0) > 0
                    and x.get("mem_bytes_in_use", 0) > 0
                    and x.get("mem_peak_bytes", 0) > 0):
                raise AssertionError(f"iteration {r.it}: extras {x}")
        names = [p["name"] for p in phases]
        if set(names) != set(TEL_PHASES):
            raise AssertionError(f"phase records {names}")
        disp = meta.get("kernel_dispatch", {}).get("ell_lap_matvec", {})
        if (disp.get("path"), disp.get("reason"), disp.get("layout")) != (
                "kernel", "cuda-default", default):
            raise AssertionError(f"kernel_dispatch {meta.get('kernel_dispatch')}")
        with open(f"{d}/trace.json") as f:
            trace = json.load(f)
        events = trace["traceEvents"]
        for e in events:
            if (e["ph"] != "X" or e["ts"] < 0 or e["dur"] < 0
                    or "pid" not in e or "tid" not in e):
                raise AssertionError(f"not a Chrome-trace complete event: {e}")
        counts = {}
        for e in events:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
        missing = [s for s in (*TEL_PHASES, *TEL_STEPS) if s not in counts]
        if (missing or counts.get("solve-iter") != spec.max_iters
                or counts.get("kernel/ell_lap_matvec", 0) < 1):
            raise AssertionError(f"trace spans {counts} (missing {missing})")
        pcg = [r.extras["pcg_iters"] for r in records]
        say("telemetry", f"tsne N={res.X.shape[0]} from Y with telemetry: "
                         f"{res.n_iters} iterations, wall {wall:.1f} s; "
                         f"energies and X bit-equal to phase fit_sparse's "
                         f"fit without telemetry; run.jsonl: "
                         f"{len(records)} iteration records (pcg_iters "
                         f"{pcg}, z_ema {records[-1].extras['z_ema']:.6g}, "
                         f"mem_bytes_in_use "
                         f"{records[-1].extras['mem_bytes_in_use'] / 1e6:.1f}"
                         f" MB, mem_peak_bytes "
                         f"{records[-1].extras['mem_peak_bytes'] / 1e6:.1f} "
                         f"MB), phases {names}, kernel_dispatch "
                         f"ell_lap_matvec {disp}")
        say("telemetry", f"trace.json: {len(events)} complete events; "
                         + ", ".join(f"{k} {v}" for k, v in
                                     sorted(counts.items())))
        say("telemetry", "the report CLI (python -m repro_torch.obs.report "
                         "run.jsonl):")
        report.main([f"{d}/run.jsonl", "--max-rows", "10"])
        sys.stdout.flush()

    # the overhead: the same ten iterations from the fit's graph and start
    # without and with telemetry, in turns (off, on, on, off)
    ms = {False: [], True: []}
    for on in (False, True, True, False):
        r = Embedding(spec).fit(None, X0=ref.X0_, saff=ref.affinities_,
                                telemetry=on)
        ms[on].append(_iter_ms(r.result_))
    ms_on, ms_off = np.median(ms[True]), np.median(ms[False])
    say("telemetry", f"median ms an iteration, from the fit's graph and "
                     f"start in turns (off, on, on, off): {ms_on:.2f} with "
                     f"telemetry ({ms[True][0]:.2f}, {ms[True][1]:.2f}), "
                     f"{ms_off:.2f} without ({ms[False][0]:.2f}, "
                     f"{ms[False][1]:.2f}), ratio {ms_on / ms_off:.3f} (the "
                     f"reference's budget {1 + TEL_BUDGET:.2f}; printed, not "
                     f"held: this path's host noise is larger)")

    # profiler annotations: a short fit from the same graph and start
    tel = Telemetry(profiler_annotations=True)
    short = spec.replace(max_iters=3)
    sparse_attractive.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        Embedding(short).fit(None, X0=ref.X0_, saff=ref.affinities_,
                             telemetry=tel)
        torch.cuda.synchronize()
    launches[f"ell_lap_matvec_{default}"] += sparse_attractive.launch_counts[
        f"ell_lap_matvec_{default}"]
    if launches[f"ell_lap_matvec_{default}"] < 1:
        raise AssertionError(f"telemetry phase: ELL launches {launches}")
    evs = prof.key_averages()
    ann = {e.key: e.count for e in evs if e.key == "solve-iter"}
    ell = sum(e.count for e in evs if e.device_type == DeviceType.CUDA
              and "ell_gather" in e.key)
    if ann.get("solve-iter") != short.max_iters or ell < 1:
        raise AssertionError(f"profile: solve-iter annotations {ann}, ELL "
                             f"kernel events {ell}")
    say("telemetry", f"under torch.profiler with profiler_annotations=True: "
                     f"{ann['solve-iter']} solve-iter user annotations beside "
                     f"{ell} ELL kernel (ell_gather) CUDA events")
    return {"launches": launches[f"ell_lap_matvec_{default}"]}


def _dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


def _resume_case(tag: str, spec, stop: int, want, *, ckdir, fit_kw,
                 Y=None, telemetry=None, **est_kw) -> dict:
    """`Embedding(spec)` stopped at `stop` (the save timed by the telemetry
    span ``checkpoint``), then a fresh estimator's `resume` to
    `spec.max_iters`: bit-equal energies after the checkpoint and X against
    the uninterrupted `want` (energies, X)."""
    from repro_torch.api import Embedding
    from repro_torch.obs import Telemetry, resolve_telemetry

    part = spec.replace(max_iters=stop, checkpoint_dir=str(ckdir))
    tel = resolve_telemetry(telemetry) or Telemetry()
    t0 = time.perf_counter()
    Embedding(part, **est_kw).fit(Y, telemetry=tel, **fit_kw)
    torch.cuda.synchronize()
    wall_part = time.perf_counter() - t0
    spans = {}
    for e in tel.tracer.events:        # the last save's spans
        spans[e["name"]] = e["dur"] / 1e6
    save_s = spans["checkpoint"]
    parts = ", ".join(f"{k.split('/')[1]} {spans[k]:.2f} s"
                      for k in ("checkpoint/device-to-host",
                                "checkpoint/write", "checkpoint/hash"))
    nbytes = _dir_bytes(Path(ckdir) / f"step_{stop:012d}")
    t0 = time.perf_counter()
    emb = Embedding(part, **est_kw).resume(Y, max_iters=spec.max_iters,
                                           telemetry=telemetry, **fit_kw)
    torch.cuda.synchronize()
    wall_resume = time.perf_counter() - t0
    res = emb.result_
    if res.resumed_from != stop or res.n_iters != spec.max_iters - stop:
        raise AssertionError(f"{tag}: resumed_from {res.resumed_from}, "
                             f"{res.n_iters} iterations")
    e_want, X_want = want
    _held_equal(tag, res.energies[1:], e_want[stop + 1:],
                "energies after the checkpoint")
    _held_equal(tag, emb.embedding_, X_want, "X")
    say("resume", f"{tag}: stopped at {stop} (save of {nbytes / 1e6:.1f} MB "
                  f"in {save_s:.2f} s: {parts}; {nbytes / 1e9 / save_s:.2f} "
                  f"GB/s; fit {wall_part:.1f} s), resumed to "
                  f"{spec.max_iters} from step {res.resumed_from} "
                  f"({wall_resume:.1f} s, its set-up run again): energies "
                  f"after the checkpoint and X bit-equal to the "
                  f"uninterrupted run; E at the restored X "
                  f"{res.energies[0]:.8g} (uninterrupted "
                  f"{e_want[stop]:.8g})")
    return {"bytes": nbytes, "save_s": save_s}


def phase_resume(dense: dict, sparse: dict, tree: dict, sharded: dict,
                 mesh_fit: dict) -> dict:
    """Slice 6's resume path: five fits interrupted and resumed through
    `Embedding(spec).resume(Y, max_iters=...)` (module docstring, phase
    20)."""
    import shutil

    from repro_torch.api import Embedding
    from repro_torch.kernels import farfield, pairwise, sparse_attractive
    from repro_torch.obs import load_jsonl

    counters = (pairwise, sparse_attractive, farfield)
    for mod in counters:
        mod.reset_launch_counts()
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    RESUME_DIR.mkdir(parents=True)
    try:
        # dense EE (kernel 1, the 3.2 GB payload of SD's B and Cholesky
        # factor) against phase fit's uninterrupted 10 iterations, from its
        # spectral start (X0=: no eigh, which resume would discard)
        _resume_case(f"dense ee N={dense['Y'].shape[0]} SD", dense["spec"],
                     5,
                     (dense["energies"], dense["X"]),
                     ckdir=RESUME_DIR / "dense", Y=dense["Y"],
                     fit_kw={"X0": dense["X0"]})
        shutil.rmtree(RESUME_DIR / "dense")
        torch.cuda.empty_cache()
        # sparse t-SNE (kernel 2, the z carry and the PCG warm start)
        # against phase fit_sparse's fit; one telemetry directory
        fit = sparse["fits"]["tsne"]
        tel_dir = RESUME_DIR / "sparse-tel"
        n = sparse["Y"].shape[0]
        _resume_case(f"sparse tsne N={n}", fit.spec, 5,
                     (fit.result_.energies, fit.embedding_),
                     ckdir=RESUME_DIR / "sparse", Y=sparse["Y"], fit_kw={},
                     telemetry=str(tel_dir))
        its = [r.it for r in load_jsonl(str(tel_dir / "run.jsonl"))[2]]
        if its != list(range(1, fit.spec.max_iters + 1)):
            raise AssertionError(f"sparse: iteration records {its} across "
                                 f"the resume")
        say("resume", f"sparse tsne: one run.jsonl across the resume, "
                      f"iterations {its[0]}..{its[-1]} contiguous")
        # tree EE (kernel 4 through bh_tree; the deterministic (E, G) path)
        # on phase fit_sparse's EE graph, against 4 uninterrupted iterations
        saff = sparse["fits"]["ee"].affinities_
        spec = tree["fits"]["ee"].spec.replace(max_iters=4)
        full = Embedding(spec).fit(None, saff=saff)
        _resume_case(f"tree ee N={n}", spec, 2,
                     (full.result_.energies, full.embedding_),
                     ckdir=RESUME_DIR / "tree", fit_kw={"saff": saff})
        # sparse-sharded t-SNE in the one-rank NCCL group (kernel 5)
        mesh = sharded["mesh"]
        spec = sharded["fits"]["tsne"].spec.replace(max_iters=4)
        full = Embedding(spec, mesh=mesh).fit(sparse["Y"])
        _resume_case(f"sparse-sharded tsne N={n}, {mesh.size} NCCL rank",
                     spec, 2,
                     (full.result_.energies, full.embedding_),
                     ckdir=RESUME_DIR / "sharded", Y=sparse["Y"], fit_kw={},
                     mesh=mesh)
        # dense-mesh EE SD in the same group (the plain tile, no kernel)
        # against phase fit_dense_mesh's uninterrupted 10 iterations from
        # phase fit's spectral start; the block-Jacobi factor is built again
        fit = mesh_fit["fits"]["sd", "ee"]
        _resume_case(f"dense-mesh ee N={dense['Y'].shape[0]} SD, "
                     f"{mesh.size} NCCL rank", fit["spec"], 5,
                     (fit["energies"], fit["X"]),
                     ckdir=RESUME_DIR / "dense-mesh", Y=dense["Y"],
                     fit_kw={"X0": dense["X0"]}, mesh=mesh)
    finally:
        shutil.rmtree(RESUME_DIR, ignore_errors=True)
    counts = {k: v for mod in counters for k, v in mod.launch_counts.items()}
    for name in ("pairwise_terms", f"ell_lap_matvec_{sparse['default']}",
                 "bh_tree", "ell_lap_matvec_local"):
        if counts[name] < 1:
            raise AssertionError(f"the resume phase launched no {name}: "
                                 f"{counts}")
    say("resume", f"kernel launches over the phase: "
                  f"{ {k: v for k, v in counts.items() if v} }")
    return counts


# -- slice 4: the out-of-sample transform, artifacts and the server -----------

SERVE_DIR = ROOT / "build" / "chip_smoke_serve"      # git-ignored
SERVE_QUERIES = 1024
SERVE_INVARIANT_ROWS = 64
# rows transformed alone, in pairs and in chunks of 5, and rows sent to the
# server one at a time, by the invariance checks (the first of each check's
# rows; the batch takes all of them)
SERVE_ALONE_ROWS = 8
SERVE_CLIENT_ROWS = 16
SERVE_REQUESTS = 512
SERVE_CLIENTS = 8
# the reference's own bound on batch invariance (tests/test_api.py:441,445,
# tests/test_serve.py:197,213)
INVARIANCE_TOL = 1e-5
HTTP_TIMEOUT_S = 300


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def serve_queries(Y: np.ndarray, n: int, seed: int) -> tuple:
    """n seeded training rows plus N(0, 0.1^2) noise (the generator's own
    noise scale), and the rows they came from."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(Y.shape[0], n, replace=False)
    Q = Y[rows] + 0.1 * rng.normal(size=(n, Y.shape[1]))
    return Q.astype(np.float32), rows


def _gap(a, b) -> float:
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())


def _client_rows(server, Q: np.ndarray, clients: int) -> tuple:
    """Every row of Q submitted alone, `clients` threads each waiting for
    its last answer before its next request; (results, wall seconds)."""
    import threading

    out = np.zeros((Q.shape[0], 2), dtype=np.float32)
    errors = []

    def client(idxs):
        try:
            for i in idxs:
                out[i] = server.transform(Q[i], timeout=600.0)
        except Exception as e:      # reported below, fails the phase
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(range(c, Q.shape[0], clients),))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"server clients failed: {errors[:3]}")
    return out, wall


def _check_invariance(tag: str, est, Q: np.ndarray, tspec) -> None:
    """Each row's rowwise result alone, in pairs, in one batch, in chunks of
    5 and through the server (padded buckets) within INVARIANCE_TOL of the
    batch's; prints the gaps and whether every result is bit-equal."""
    # the server's batches: single rows from SERVE_CLIENTS threads, then
    # one block of 5 rows (bucket 8, padded with copies of its first row)
    from repro_torch.serve import EmbeddingServer

    n = Q.shape[0]
    m = min(n, SERVE_ALONE_ROWS)
    joint = est.transform(Q, tspec)
    ways = {
        "alone": torch.cat([est.transform(Q[i:i + 1], tspec)
                            for i in range(m)]),
        "pairs": torch.cat([est.transform(Q[i:i + 2], tspec)
                            for i in range(0, m, 2)]),
        "chunks of 5": est.transform(Q[:m], tspec.replace(batch_size=5)),
    }
    with EmbeddingServer(est, tspec, max_batch=SERVE_INVARIANT_ROWS) as srv:
        rows, _ = _client_rows(srv, Q[:SERVE_CLIENT_ROWS], SERVE_CLIENTS)
        block = srv.transform(Q[:5], timeout=600.0)   # bucket 8, padded
        stats = srv.stats()
    ways["server"] = torch.as_tensor(rows)
    ways["server block of 5"] = torch.as_tensor(block)
    gaps = {}
    for name, got in ways.items():
        want = joint.cpu()[:got.shape[0]]
        gaps[name] = (_gap(got.cpu(), want),
                      bool(torch.equal(got.cpu(), want)))
    say("serve", f"{tag}: batch invariance over {n} rows, largest gap to the "
                 f"batch of {n}: " + ", ".join(
                     f"{k} {g:.3e} ({'bit-equal' if eq else 'not bit-equal'})"
                     for k, (g, eq) in gaps.items())
        + f"; the server ran {stats['n_batches']} batches "
          f"(mean {stats.get('mean_batch', 0):.2f} rows) over buckets "
          f"{sorted(stats['cache'])}")
    worst = max(g for g, _ in gaps.values())
    if not worst <= INVARIANCE_TOL:
        raise AssertionError(f"{tag}: rowwise results depend on the batch: "
                             f"{gaps}")


def _http_round_trip(path: str, Q: np.ndarray, est, tspec) -> None:
    """`python -m repro_torch.serve.http` on the artifact (CUDA, the CLI's
    default), one POST of 3 rows held to the direct transform, then
    SIGTERM: it must drain and exit 0."""
    import os
    import signal
    import urllib.request

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.http", "--artifact", path,
         "--port", "0", "--warmup", "4"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        line = ""
        while "listening on" not in line:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"serve.http exited: "
                                     f"{proc.stderr.read()[-2000:]}")
        base = line.split("listening on ")[1].split()[0]
        up = time.perf_counter() - t0
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"{base}/transform",
            data=json.dumps({"rows": Q[:3].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        obj = json.loads(urllib.request.urlopen(
            req, timeout=HTTP_TIMEOUT_S).read())
        rtt = time.perf_counter() - t0
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=HTTP_TIMEOUT_S).read())
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=HTTP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0 or "drained and closed" not in out:
        raise AssertionError(f"serve.http did not drain and exit 0 "
                             f"(rc {proc.returncode}): {err[-2000:]}")
    got = torch.tensor(obj["embedding"], dtype=torch.float32)
    want = est.transform(Q[:3], tspec).cpu()
    gap = _gap(got, want)
    say("serve", f"http: `python -m repro_torch.serve.http` up (artifact "
                 f"loaded, warmed) in {up:.1f} s, /healthz {health}; one "
                 f"POST /transform of 3 rows {rtt * 1e3:.1f} ms round trip, "
                 f"gap to the direct transform {gap:.3e} "
                 f"({'bit-equal' if torch.equal(got, want) else 'not bit-equal'})"
                 f"; SIGTERM drained it, rc 0")
    if not gap <= INVARIANCE_TOL:
        raise AssertionError(f"HTTP round trip {got} != direct {want}")


def _timed_transform(est, Q, tspec) -> tuple:
    _sync()
    t0 = time.perf_counter()
    X = est.transform(Q, tspec)
    _sync()
    return X, (time.perf_counter() - t0) * 1e3


def _serve_profile(est, Q, tspec) -> None:
    """One 64-row rowwise batch under torch.profiler: device busy time, the
    idle share of its wall time and the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    est.transform(Q, tspec)                     # warm-up
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est.transform(Q, tspec)
        _sync()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        say("serve", "torch.profiler recorded no device kernels: device time "
                     "and idle share not measured")
        return
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[2] for r in rows)
    say("serve", f"profile: one {Q.shape[0]}-row rowwise batch "
                 f"{wall * 1e3:.1f} ms wall under the profiler, device busy "
                 f"{busy * 1e3:.2f} ms, idle share "
                 f"{max(0.0, 1 - busy / wall):.3f}, {launches} device "
                 f"kernels")
    for dev_us, key, count in rows[:6]:
        say("serve", f"  {dev_us / 1e3:8.3f} ms {count:6d} calls  {key[:80]}")


def phase_serve(tsne_est, labels: np.ndarray) -> None:
    """Slice 4's main path (module docstring, phase 21)."""
    from repro_torch.api import Embedding, TransformSpec
    from repro_torch.api.transform import _anchor_affinities, _cross_method
    from repro_torch.kernels import farfield, pairwise, sparse_attractive
    from repro_torch.serve import EmbeddingServer

    counters = (pairwise, sparse_attractive, farfield)
    for mod in counters:
        mod.reset_launch_counts()
    ee_est = Embedding.load(str(SERVE_DIR / "ee_dense.npz"))
    ests = {"tsne": tsne_est, "ee": ee_est}
    before = {k: e.embedding_.clone() for k, e in ests.items()}
    Y = tsne_est._Y_train
    Q, rows = serve_queries(Y, SERVE_QUERIES, seed=1)
    Q64 = Q[:SERVE_INVARIANT_ROWS]
    rowwise = TransformSpec(solver="rowwise")
    spec = tsne_est.spec
    k = spec.n_neighbors or int(3 * spec.perplexity)
    say("serve", f"t-SNE sparse fit: N={Y.shape[0]} D={Y.shape[1]}, k={k}, "
                 f"m={spec.transform_negatives}, transform_iters="
                 f"{spec.transform_iters}, cross-kNN "
                 f"{_cross_method(rowwise, Y.shape[0])}; {Q.shape[0]} queries")

    # 1 + 4: save -> load on CUDA -> the exhaustive (engine) transform
    path = str(SERVE_DIR / "tsne_sparse.npz")
    t0 = time.perf_counter()
    tsne_est.save(path)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = Embedding.load(path)
    t_load = time.perf_counter() - t0
    exh = TransformSpec(exhaustive=True)
    a, ms_a = _timed_transform(tsne_est, Q64, exh)
    res = tsne_est.last_transform_result_
    b, _ = _timed_transform(loaded, Q64, exh)
    if not torch.equal(a, b):
        raise AssertionError(f"loaded artifact's exhaustive transform parts "
                             f"from the in-process one by {_gap(a, b):.3e}")
    e = res.energies
    if not np.all(np.isfinite(e)) or np.any(np.diff(e) > 0):
        raise AssertionError(f"engine solver energies {e}")
    say("serve", f"artifact: save {t_save:.1f} s, load on "
                 f"{loaded.device} {t_load:.1f} s; exhaustive engine "
                 f"transform of {Q64.shape[0]} rows ({res.n_iters} "
                 f"iterations, {int(res.n_fevals[-1])} evaluations, "
                 f"{ms_a:.0f} ms) bit-equal after the round trip; energies "
                 f"{e[0]:.6g} -> {e[-1]:.6g}, finite, never increasing")

    # 3: rowwise batch invariance, approximate (t-SNE) and exact (EE) kNN
    _check_invariance(f"tsne ({_cross_method(rowwise, Y.shape[0])} "
                      f"cross-kNN)", tsne_est, Q64, rowwise)
    _check_invariance(f"tsne, exhaustive repulsion over all {Y.shape[0]} "
                      f"anchors", tsne_est, Q[:16],
                      rowwise.replace(exhaustive=True))
    Qee, _ = serve_queries(ee_est._Y_train, SERVE_INVARIANT_ROWS, seed=2)
    _check_invariance(f"ee (exact cross-kNN, N={ee_est.embedding_.shape[0]}"
                      f", lambda={ee_est.spec.lam:g})", ee_est, Qee, rowwise)

    # 5: the HTTP front-end as its CLI on localhost
    _http_round_trip(path, Q, tsne_est, rowwise)

    # printed, not held: the CPU path on the same rows from the artifact
    cpu_spec = TransformSpec(solver="rowwise", exhaustive=True, max_iters=3)
    t0 = time.perf_counter()
    on_cpu = Embedding.load(path, device="cpu").transform(Q64, cpu_spec)
    t_cpu = time.perf_counter() - t0
    on_gpu = tsne_est.transform(Q64, cpu_spec).cpu()
    A = tsne_est.embedding_
    a_rms = float(torch.sqrt(torch.mean((A - A.mean(0)) ** 2)))
    gap = _gap(on_cpu, on_gpu)
    say("serve", f"CPU path (device='cpu', exhaustive, 3 iterations, "
                 f"{t_cpu:.1f} s): largest gap to the card {gap:.3e}, "
                 f"{gap / a_rms:.2e} of the anchors' rms {a_rms:.3f}")

    # measured: direct rowwise transforms, the cross-kNN alone
    for n in (1, SERVE_INVARIANT_ROWS, SERVE_QUERIES):
        tsne_est.transform(Q[:n], rowwise)                    # warm-up
        X, ms = _timed_transform(tsne_est, Q[:n], rowwise)
        r = tsne_est.last_transform_result_
        say("serve", f"direct rowwise transform of {n} rows: {ms:.1f} ms, "
                     f"{r.n_iters} iterations, {r.n_evals / r.n_iters:.2f} "
                     f"energy evaluations and {r.n_reads / r.n_iters:.2f} "
                     f"device reads an iteration ({r.n_reads} reads, "
                     f"{r.n_converged} rows frozen)")
        if n == SERVE_QUERIES:
            Xn = X.cpu().numpy()
            Xt = A.cpu().numpy()
            cents = np.stack([Xt[labels == c].mean(0) for c in range(10)])
            d = ((Xn[:, None, :] - cents[None]) ** 2).sum(-1)
            share = float((d.argmin(1) == labels[rows]).mean())
            say("serve", f"{share:.3f} of the {n} queries lie nearest their "
                         f"own class's centroid")
    Yt = tsne_est._train_tensor()
    for n in (1, SERVE_INVARIANT_ROWS, SERVE_QUERIES):
        Qn = torch.as_tensor(Q[:n], device=Yt.device)
        def knn():
            return _anchor_affinities(Qn, Yt, k, float(spec.perplexity),
                                      method=_cross_method(rowwise,
                                                           Yt.shape[0]))
        knn()
        _sync()
        t0 = time.perf_counter()
        knn()
        _sync()
        say("serve", f"cross-kNN and calibration alone for {n} rows: "
                     f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    _serve_profile(tsne_est, Q64, rowwise)

    # measured: single-row requests from client threads
    with EmbeddingServer(tsne_est, rowwise,
                         max_batch=SERVE_INVARIANT_ROWS) as srv:
        srv.warmup()
        served, wall = _client_rows(srv, Q[:SERVE_REQUESTS], SERVE_CLIENTS)
    st = srv.stats()
    lat = st["latency"]
    say("serve", f"server: {SERVE_REQUESTS} single-row requests from "
                 f"{SERVE_CLIENTS} threads in {wall:.2f} s "
                 f"({SERVE_REQUESTS / wall:.1f} rows/s); latency p50 "
                 f"{lat['p50_ms']:.1f} ms, p90 {lat['p90_ms']:.1f} ms, p99 "
                 f"{lat['p99_ms']:.1f} ms, max {lat['max_ms']:.1f} ms; "
                 f"{st['n_batches']} batches, mean batch "
                 f"{st['mean_batch']:.2f} rows; busy {st['busy_s']:.2f} s")
    _serve_with_telemetry(tsne_est, rowwise, Q[:SERVE_REQUESTS], served)

    # 2: the training embeddings are untouched
    for name, est in ests.items():
        if not torch.equal(est.embedding_, before[name]):
            raise AssertionError(f"{name}: embedding_ changed while serving")
    launched = {k: v for mod in counters for k, v in mod.launch_counts.items()
                if v}
    say("serve", f"embedding_ of both fits bit-identical after every request;"
                 f" kernel launches while serving: {launched or 'none'} (the "
                 f"transform is plain PyTorch)")


def _serve_with_telemetry(est, tspec, Q: np.ndarray, served: np.ndarray
                          ) -> None:
    """The measured requests again through `EmbeddingServer(telemetry=)`:
    one ok request record each, one ``serve/batch`` span a batch, and the
    rows of the server without telemetry, bit for bit."""
    import tempfile

    from repro_torch.obs import load_requests
    from repro_torch.serve import EmbeddingServer

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        with EmbeddingServer(est, tspec, max_batch=SERVE_INVARIANT_ROWS,
                             telemetry=d) as srv:
            rows, wall = _client_rows(srv, Q, SERVE_CLIENTS)
        st = srv.stats()
        recs = load_requests(f"{d}/run.jsonl")
        with open(f"{d}/trace.json") as f:
            spans = sum(e["name"] == "serve/batch"
                        for e in json.load(f)["traceEvents"])
    ok = [r for r in recs if r.status == "ok"]
    if len(recs) != Q.shape[0] or len(ok) != Q.shape[0]:
        raise AssertionError(f"{len(recs)} request records, {len(ok)} ok, "
                             f"for {Q.shape[0]} requests")
    if spans != st["n_batches"]:
        raise AssertionError(f"{spans} serve/batch spans for "
                             f"{st['n_batches']} batches")
    if not np.array_equal(rows, served):
        raise AssertionError(f"rows with telemetry differ from the server's "
                             f"without it by {_gap(rows, served):.3e}")
    q = np.array([r.queue_s for r in ok]) * 1e3
    c = np.array([r.compute_s for r in ok]) * 1e3
    lat = st["latency"]
    say("serve", f"server with telemetry: {len(ok)} request records "
                 f"(status ok), {spans} serve/batch spans for "
                 f"{st['n_batches']} batches; rows bit-equal to the server "
                 f"without telemetry; {Q.shape[0] / wall:.1f} rows/s, p50 "
                 f"{lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms; per "
                 f"request median queue {np.median(q):.1f} ms, compute "
                 f"{np.median(c):.1f} ms")


# -- phase lm_serve: the LM scaffolding's serving path -----------------------------

# the reference serve driver's defaults (src/repro/launch/serve.py:34-38)
LM_SERVE = {"batch": 4, "prompt_len": 32, "decode_tokens": 16,
            "temperature": 1.0}
LM_CHECK_STEPS = 4     # teacher-forced decode steps held against a prefill
LM_PREFILL_TOL = 5e-2  # decode against prefill, tests/test_models_smoke.py:88
LM_F32_TOL = 1e-4      # float32 leaves, card vs CPU (of the leaf's scale)
# the families at full width, each at the depth one card holds with f32
# master weights (None: every layer); MoE with capacity_factor 8, as the
# reference's decode/prefill test (no capacity drops)
LM_FULL = (("qwen2-7b", None), ("rwkv6-7b", None), ("zamba2-2.7b", None),
           ("musicgen-medium", None), ("llama-3.2-vision-90b", 5),
           ("grok-1-314b", 1))
LM_SMOKE_ONLY = {
    "llama4-maverick-400b-a17b": "one group (2 layers) is 74.2 GB in f32",
    "nemotron-4-340b": "one layer is 51.6 GB in f32",
    "yi-34b": "dense like qwen2-7b, which runs at full size",
    "codeqwen1.5-7b": "dense like qwen2-7b, which runs at full size",
}
# the bf16 decode/prefill gap by depth (zamba2: whole groups of 6 layers)
LM_DEPTHS = {"qwen2-7b": (1, 7, 28), "rwkv6-7b": (1, 8, 32),
             "zamba2-2.7b": (6, 18, 54)}
# families whose bf16 gap is held (the issue's qwen2-7b); every family's
# float32 gap is held, every bf16 gap printed
LM_HOLD_BF16 = ("dense",)
LM_TIMEOUT_S = 900
LM_DEVICE = "cuda"   # the card (a CPU rehearsal sets "cpu")


def _lm_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _lm_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _lm_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _lm_map(fn, tree):
    """`fn` over the tensor leaves of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _lm_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_lm_map(fn, v) for v in tree]
    return fn(tree)


def _lm_to(tree, device):
    return _lm_map(lambda t: t.to(device), tree)


def _lm_rel(want, got) -> float:
    a, b = want.detach().double().cpu(), got.detach().double().cpu()
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-300))


def _lm_held(tag: str, want, got) -> float:
    """The CPU's tree against the card's: the same leaves, shapes and
    dtypes; float32 within LM_F32_TOL of the leaf's scale, bf16 within
    one ulp of it, ints exactly.  Returns the largest float32 gap."""
    w, g = dict(_lm_leaves(want)), dict(_lm_leaves(got))
    if w.keys() != g.keys():
        raise AssertionError(f"lm_serve {tag}: leaves {w.keys() ^ g.keys()}")
    worst = 0.0
    for path, a in w.items():
        b = g[path].cpu()
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"lm_serve {tag}{path}: {a.dtype} "
                                 f"{tuple(a.shape)} vs {b.dtype} "
                                 f"{tuple(b.shape)}")
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"lm_serve {tag}{path}: ints differ")
            continue
        scale = float(a.abs().max())
        gap = _lm_rel(a, b) if scale > 0 else float(b.abs().max())
        # bf16: one ulp of the leaf's largest value, 2^(e - 7) for a largest
        # value in [2^e, 2^(e + 1)): between 2^-8 and 2^-7 of it
        tol = (2.0 ** (math.floor(math.log2(scale)) - 7) / scale
               if a.dtype == torch.bfloat16 and scale > 0 else LM_F32_TOL)
        if not gap <= tol:
            raise AssertionError(f"lm_serve {tag}{path}: gap {gap:.3e} of "
                                 f"the leaf's scale > {tol:.3e}")
        if a.dtype == torch.float32:
            worst = max(worst, gap)
    return worst


def _lm_smoke_vs_cpu(arch: str) -> str:
    """A smoke config at float32 compute on the card and the CPU, the same
    params and tokens: a prefill and LM_CHECK_STEPS teacher-forced decode
    steps, each step from the CPU's caches and the next token."""
    from repro_torch.configs import RunConfig, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for
    from repro_torch.models import build_model

    dev = torch.device(LM_DEVICE)
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    model = build_model(cfg, RunConfig(remat="none"))
    params, _ = model.init_params(0, device="cpu")
    gparams = _lm_to(params, dev)
    T, K = 10, LM_CHECK_STEPS
    full = batch_for(cfg, ShapeConfig("p", "prefill", T + K, 2), device="cpu")
    head = {**full, "tokens": full["tokens"][:, :T]}
    cl, cc = model.prefill(params, head, max_len=T + K)
    gl, gc = model.prefill(gparams, _lm_to(head, dev), max_len=T + K)
    worst = max(_lm_held(f"{arch} prefill logits", cl, gl),
                _lm_held(f"{arch} prefill caches", cc, gc))
    for i in range(K):
        tok = full["tokens"][:, T + i][:, None]
        gl, gc = model.decode_step(gparams, _lm_to(cc, dev), tok.to(dev))
        cl, cc = model.decode_step(params, cc, tok)
        worst = max(worst, _lm_held(f"{arch} step {i + 1} logits", cl, gl),
                    _lm_held(f"{arch} step {i + 1} caches", cc, gc))
    return f"{arch}: largest float32 gap {worst:.2e} of the leaf's scale"


def _lm_decode_gap(model, params, cfg, depth=None, compute=None) -> float:
    """The port's own chain: a prefill of T tokens, LM_CHECK_STEPS decode
    steps on the next tokens, against a prefill over all T + K (the last
    position's logits).  `depth` keeps the first layers of the stack
    (whole groups), `compute` overrides the compute dtype."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for
    from repro_torch.models import block_pattern

    if compute is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute)
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
        n = block_pattern(cfg)[1]
        params = {**params, "slots": _lm_map(lambda t: t[:n],
                                             params["slots"])}
    model = dataclasses.replace(model, cfg=cfg)
    T, K, B = LM_SERVE["prompt_len"], LM_CHECK_STEPS, LM_SERVE["batch"]
    full = batch_for(cfg, ShapeConfig("p", "prefill", T + K, B),
                     device=LM_DEVICE)
    want, _ = model.prefill(params, full)
    _, caches = model.prefill(params, {**full, "tokens": full["tokens"][:, :T]},
                              max_len=T + K)
    for i in range(K):
        got, caches = model.decode_step(params, caches,
                                        full["tokens"][:, T + i][:, None])
    return _lm_rel(want.float(), got.float())


def _lm_guarded_decode(model, params, cfg) -> str:
    """Warmed decode steps of the full model: one warm-up step, one under
    the sync-debug mode "warn" (every unsanctioned host wait listed), one
    under `assert_compile_count(expected=0)` and `no_implicit_transfers()`;
    the sampled tokens' read is the step's one `explicit_read`."""
    import traceback
    import warnings

    from repro_torch.analysis import (assert_compile_count, explicit_read,
                                      no_implicit_transfers)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for
    from repro_torch.launch.serve import SAMPLE_SEED, sample_tokens

    B, T = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    batch = batch_for(cfg, ShapeConfig("p", "prefill", T, B), device=LM_DEVICE)
    logits, caches = model.prefill(params, batch, max_len=T + 3)
    gen = torch.Generator(device=LM_DEVICE).manual_seed(SAMPLE_SEED)

    def step(logits, caches):
        tok = sample_tokens(logits.reshape(B, -1, cfg.vocab_size),
                            LM_SERVE["temperature"], gen).reshape(B, 1)
        logits, caches = model.decode_step(params, caches, tok)
        with explicit_read():
            tok.cpu()
        return logits, caches

    logits, caches = step(logits, caches)       # warm-up
    torch.cuda.synchronize()
    sites = set()

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            frames = [f"{Path(f.filename).name}:{f.lineno}"
                      for f in traceback.extract_stack()[:-1]
                      if "repro_torch" in f.filename]
            sites.add(" < ".join([f"{Path(filename).name}:{lineno}",
                                  *frames[::-1][:4]]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        with no_implicit_transfers(mode="warn"):
            logits, caches = step(logits, caches)
    if sites:
        raise AssertionError(f"lm_serve guard: unsanctioned host waits at "
                             f"{'; '.join(sorted(sites))}")
    t0 = time.perf_counter()
    with assert_compile_count(expected=0, label="lm decode") as counter, \
            no_implicit_transfers():
        logits, caches = step(logits, caches)
    ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("lm_serve guard: non-finite logits")
    return (f"guard: a warmed {cfg.name} decode step under "
            f"assert_compile_count(expected=0) and no_implicit_transfers(): "
            f"{counter.count} builds or searches, no unsanctioned host wait "
            f"(warn pass: none listed); {ms:.1f} ms")


def _lm_profile(model, params, cfg, steps: int = 3) -> str:
    """Where a warmed decode step's time goes: `steps` steps under
    torch.profiler, device busy time, idle share, launches and the top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for

    B, T = LM_SERVE["batch"], LM_SERVE["prompt_len"]
    batch = batch_for(cfg, ShapeConfig("p", "prefill", T, B),
                      device=LM_DEVICE)
    _, caches = model.prefill(params, batch, max_len=T + steps + 1)
    tok = batch["tokens"][:, :1]
    _, caches = model.decode_step(params, caches, tok)       # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _, caches = model.decode_step(params, caches, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    if not rows:
        return "torch.profiler recorded no device kernels: not measured"
    busy = sum(r[0] for r in rows) / 1e6
    launches = sum(r[2] for r in rows) // steps
    top = "; ".join(f"{us / 1e3 / steps:.2f} ms x{n // steps} {key[:60]}"
                    for us, key, n in rows[:5])
    return (f"profile of {steps} warmed {cfg.name} decode steps: "
            f"{wall * 1e3 / steps:.2f} ms wall a step, device busy "
            f"{busy * 1e3 / steps:.2f} ms, idle share "
            f"{max(0.0, 1 - busy / wall):.2f}, {launches} kernels a step; "
            f"top: {top}")


def _lm_params_gb(params) -> tuple[float, float]:
    n = sum(t.numel() for _, t in _lm_leaves(params))
    return n / 1e9, sum(t.numel() * t.element_size()
                        for _, t in _lm_leaves(params)) / 1e9


def _lm_full(arch: str, depth, card: str) -> dict:
    """One family at full width (its depth cut to `depth` groups' worth of
    layers): the reference driver's serving loop twice (the first call
    cold), the decode/prefill gap, finite logits, peak memory."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import build_model
    from repro_torch.serve.metrics import percentiles

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if depth is not None:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, RunConfig(remat="none"))
    params, _ = model.init_params(0, device=LM_DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_b, gb = _lm_params_gb(params)
    say("lm_serve", f"{arch}: {cfg.num_layers} of {full_layers} layers "
                    f"(depth cut: {'none' if depth is None else depth}), "
                    f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
                    f"{n_b:.3f} B params, {gb:.2f} GB in {cfg.param_dtype}, "
                    f"compute {cfg.compute_dtype}; drawn on the card in "
                    f"{init_s:.2f} s")
    runs = [serve_lm(cfg, params=params, device=LM_DEVICE, **LM_SERVE)
            for _ in range(2)]
    out = runs[1]
    if not bool(torch.isfinite(out["logits"].float()).all()):
        raise AssertionError(f"lm_serve {arch}: non-finite logits")
    steps_ms = [s * 1e3 for s in out["step_s"]]
    pct = percentiles(steps_ms, qs=(50, 99))
    toks = LM_SERVE["batch"] * LM_SERVE["decode_tokens"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    gap = _lm_decode_gap(model, params, cfg)
    gap32 = _lm_decode_gap(model, params, cfg, compute="float32")
    rec = {"arch": arch, "layers": cfg.num_layers, "params_b": n_b,
           "params_gb": gb, "prefill_ms": out["prefill_s"] * 1e3,
           "prefill_cold_ms": runs[0]["prefill_s"] * 1e3,
           "decode_p50_ms": pct["p50"], "decode_p99_ms": pct["p99"],
           "decode_tok_s": toks / out["decode_s"],
           "prefill_tok_s": (LM_SERVE["batch"] * LM_SERVE["prompt_len"]
                             / out["prefill_s"]),
           "peak_gb": peak, "decode_vs_prefill": gap,
           "decode_vs_prefill_f32": gap32,
           "held": ["float32"] + (["bfloat16"] if cfg.family in LM_HOLD_BF16
                                  else [])}
    say("lm_serve", f"{arch} on {card}: batch {LM_SERVE['batch']} x "
                    f"({LM_SERVE['prompt_len']} + "
                    f"{LM_SERVE['decode_tokens']}) tokens: prefill "
                    f"{rec['prefill_ms']:.2f} ms (first call "
                    f"{rec['prefill_cold_ms']:.2f} ms), decode p50 "
                    f"{pct['p50']:.2f} / p99 {pct['p99']:.2f} ms a step, "
                    f"{rec['decode_tok_s']:.1f} tokens/s decoding, peak "
                    f"memory {peak:.2f} GB; decode vs prefill over "
                    f"{LM_CHECK_STEPS} steps: rel gap {gap:.3e} at "
                    f"{cfg.compute_dtype}, {gap32:.3e} at float32 compute "
                    f"(bound {LM_PREFILL_TOL}, held at "
                    f"{' and '.join(rec['held'])})")
    if arch in LM_DEPTHS:
        gaps = {d: _lm_decode_gap(model, params, cfg, depth=d)
                for d in LM_DEPTHS[arch]}
        say("lm_serve", f"{arch} decode vs prefill gap at "
                        f"{cfg.compute_dtype} by depth: " +
            ", ".join(f"{d} layers {g:.3e}" for d, g in gaps.items()))
    if arch == "qwen2-7b":
        say("lm_serve", _lm_profile(model, params, cfg))
        say("lm_serve", _lm_guarded_decode(model, params, cfg))
        # the reference's serve_param_dtype knob: the params cast to bf16
        # once, so _proj's per-call cast is a no-op (not the default path)
        bf16 = _lm_map(lambda t: t.to(torch.bfloat16)
                       if t.is_floating_point() else t, params)
        del params
        torch.cuda.empty_cache()
        cast = serve_lm(cfg, params=bf16, device=LM_DEVICE, **LM_SERVE)
        cast = serve_lm(cfg, params=bf16, device=LM_DEVICE, **LM_SERVE)
        cp = percentiles([s * 1e3 for s in cast["step_s"]], qs=(50, 99))
        rec["bf16_params_decode_p50_ms"] = cp["p50"]
        say("lm_serve", f"qwen2-7b with its params cast to bf16 once "
                        f"(serve_param_dtype), not the default path: "
                        f"prefill {cast['prefill_s'] * 1e3:.2f} ms, decode "
                        f"p50 {cp['p50']:.2f} / p99 {cp['p99']:.2f} ms a "
                        f"step; weight bytes a decode step: {gb:.2f} GB "
                        f"(f32 masters, {gb / PEAK_BYTES_PER_S * 1e12:.2f} "
                        f"ms at {PEAK_BYTES_PER_S / 1e12} TB/s) or "
                        f"{gb / 2:.2f} GB (bf16, "
                        f"{gb / 2 / PEAK_BYTES_PER_S * 1e12:.2f} ms)")
        del bf16
    del runs, out
    torch.cuda.empty_cache()
    return rec


def lm_serve_child() -> int:
    """Phase lm_serve's body, in a process of its own (so that its tens of
    GB do not stack on the earlier phases' tensors): prints its lines and,
    last, a JSON record for the parent."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.kernels import farfield, pairwise, sparse_attractive

    card = smi()
    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        say("lm_serve", "smoke, card vs CPU, f32 compute: "
                        + _lm_smoke_vs_cpu(arch))
    say("lm_serve", f"ten smoke archs on the card and the CPU: "
                    f"{time.perf_counter() - t0:.1f} s")
    for arch, why in LM_SMOKE_ONLY.items():
        say("lm_serve", f"{arch}: smoke size only ({why})")
    records = [_lm_full(arch, depth, card) for arch, depth in LM_FULL]
    bad = [r["arch"] for r in records
           if not r["decode_vs_prefill_f32"] < LM_PREFILL_TOL
           or ("bfloat16" in r["held"]
               and not r["decode_vs_prefill"] < LM_PREFILL_TOL)]
    if bad:
        raise AssertionError(f"lm_serve: decode vs prefill above "
                             f"{LM_PREFILL_TOL} for {bad}")
    counts = {**pairwise.launch_counts, **sparse_attractive.launch_counts,
              **farfield.launch_counts}
    if any(counts.values()):
        raise AssertionError(f"lm_serve launched a kernel: {counts}")
    print(json.dumps({"lm_serve": records, "kernel_launches": counts}))
    return 0


def phase_lm_serve() -> list:
    """The LM scaffolding's serving path (configs/, models/, batch_for,
    launch/serve.py) in a fresh process; the five kernels' launch counts of
    this process must not move."""
    import os

    from repro_torch.kernels import farfield, pairwise, sparse_attractive

    def counts():
        return {**pairwise.launch_counts, **sparse_attractive.launch_counts,
                **farfield.launch_counts}

    before = counts()
    torch.cuda.empty_cache()
    say("lm_serve", f"{smi()}; this process holds "
                    f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    code = ("import sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
            "import chip_smoke\n"
            "sys.exit(chip_smoke.lm_serve_child())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True,
                          timeout=LM_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"lm_serve: the child failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-6000:]}")
    out = json.loads(lines[-1])
    if counts() != before:
        raise AssertionError(f"lm_serve moved the kernels' launch counts: "
                             f"{before} -> {counts()}")
    say("lm_serve", f"the five kernels' launch counters of this process "
                    f"read the same before and after the phase "
                    f"({sum(before.values())} since their last reset); the "
                    f"child launched none: {out['kernel_launches']}")
    return out["lm_serve"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    secs = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        return out

    run("probe", phase_probe)
    run("build", phase_build)
    run("check", phase_check)
    run("check_ell", phase_check_ell)
    fit = run("fit", phase_fit)
    fit_launches = fit["launches"]
    dense_ref = fit["resume_ref"]
    timing = run("time", phase_time, fit["data"])
    run("profile", phase_profile, fit["emb"])
    fit["emb"] = None
    lineup = run("fit_lineup", phase_fit_lineup, fit["starts"],
                 fit["settled"])
    dense_starts = {kind: X0 for kind, (X0, _) in fit["starts"].items()}
    dense_data = fit["data"]      # phase autotune's pairwise shapes
    del fit
    torch.cuda.empty_cache()
    sparse = run("fit_sparse", phase_fit_sparse)
    timing_ell, ell_rule = run("time_ell", phase_time_ell, sparse["fits"])
    run("profile_sparse", phase_profile_sparse, sparse["fits"]["tsne"])
    run("check_bh", phase_check_bh)
    tree = run("fit_tree", phase_fit_tree, sparse["fits"])
    run("check_bh", phase_check_bh_fits, tree["fits"])
    timing_bh = run("time_bh", phase_time_bh, tree["fits"]["tsne"])
    run("profile_tree", phase_profile_tree, tree["fits"]["tsne"])
    run("check_ell_local", phase_check_ell_local, sparse["fits"])
    sharded = run("fit_sharded", phase_fit_sharded, sparse)
    run("fit_sharded_2rank", phase_fit_sharded_2rank, sharded)
    timing_local = run("time_ell_local", phase_time_ell_local, sharded)
    tuned = run("autotune", phase_autotune, dense_data, dense_ref["spec"],
                sparse["fits"], sharded, tree["fits"])
    del dense_data
    torch.cuda.empty_cache()
    run("profile_sharded", phase_profile_sharded, sharded["fits"]["tsne"],
        sharded["mesh"])
    mesh_fit = run("fit_dense_mesh", phase_fit_dense_mesh, dense_ref,
                   dense_starts, sharded["mesh"])
    run("fit_dense_mesh_4rank", phase_fit_dense_mesh_4rank, sharded["mesh"])
    tel = run("telemetry", phase_telemetry, sparse)
    resumed = run("resume", phase_resume, dense_ref, sparse, tree, sharded,
                  mesh_fit)
    del dense_ref
    dist.destroy_process_group()
    run("serve", phase_serve, sparse["fits"]["tsne"], sparse["labels"])
    run("lm_serve", phase_lm_serve)
    say("done", "seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()))
    say("done", f"{time.perf_counter() - t_start:.1f} s")
    from repro_torch.kernels.ops import ELL_DEFAULT_LAYOUT
    if ell_rule != ELL_DEFAULT_LAYOUT:
        # the constant is set by hand from a run's numbers, so a run that
        # reads the other way says so here, where the summary is read
        say("done", f"WARNING: time_ell's rule (staged faster on all eight "
                    f"graphs and storages) picks {ell_rule!r}, but "
                    f"ops.ELL_DEFAULT_LAYOUT is {ELL_DEFAULT_LAYOUT!r}")

    f32 = timing["tsne", "float32"]     # the costlier main-path kind
    if fit_launches < 1:
        raise AssertionError("the main path launched no pairwise kernel")
    kernels = [{
        "name": "pairwise_terms", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pairwise.cu",
        "replaces": "src/repro/kernels/pairwise.py:131",
        "launches": (fit_launches + lineup["launches"]
                     + resumed["pairwise_terms"]),
        "launches_from": "the dense SD fits (phase fit), the lineup "
                         "(phase fit_lineup: DiagH, CG, L-BFGS and SD- on EE "
                         "and t-SNE, SparseSD and homotopy_path on EE) and "
                         "the dense EE fit stopped and resumed (phase "
                         "resume)",
        **kernel_numbers(f32),
        **tuned_numbers(tuned, f"pairwise tsne N={N_FIT} float32")}]
    # the ELL kernels at the wider of the main path's two graphs: the EE
    # fit's reverse graph, float32.  The default layout's launches are the
    # two default fits'; the other's come from the EE fit run again with its
    # CG operator on that layout
    default, other = sparse["default"], sparse["other"]
    launches = {default: (sparse["launches"][default]
                          + lineup["ell_launches"] + tel["launches"]
                          + resumed[f"ell_lap_matvec_{default}"],
                          "the default EE and t-SNE sparse fits, the "
                          "SparseSD fit of phase fit_lineup, the t-SNE fits "
                          "with telemetry (phase telemetry) and the sparse "
                          "and tree fits stopped and resumed (phase "
                          "resume)"),
                other: (sparse["launches_other_fit"][
                    f"ell_lap_matvec_{other}"],
                        f"the EE sparse fit with ell_layout={other!r}")}
    ell_k = sparse["fits"]["ee"].affinities_.rev.k
    for layout, line in (("vmem", 96), ("hbm", 186)):
        t = timing_ell["ee", "reverse", "float32", layout]
        n_launch, origin = launches[layout]
        if n_launch < 1:
            raise AssertionError(f"{origin} launched no ELL {layout} kernel")
        kernels.append({
            "name": f"ell_lap_matvec_{layout}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ell.cu",
            "replaces": f"src/repro/kernels/sparse_attractive.py:{line}",
            "launches": n_launch, "launches_from": origin,
            **kernel_numbers(t),
            **tuned_numbers(tuned, f"ell {layout} reverse k={ell_k} "
                                   f"N={N_SPARSE} float32")})
    # the per-batch cell-interaction kernel at its widest batch: a near
    # chunk (W = 128, table = X) on the t-SNE tree fit's embedding, float32.
    # No default path launches it any more (the tree fits launch the fused
    # kernel instead, and fit_tree asserts 0 per-batch launches there), so
    # its main-path count is 0; the tree fits' 3-iteration reruns through
    # the per-batch path (_tree_repulsion_batched) stand apart
    if tree["launches_per_batch"] < 1:
        raise AssertionError("the per-batch tree reruns launched no "
                             "cell-interaction kernel")
    kernels.append({
        "name": "bh_interaction", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/farfield.cu",
        "replaces": "src/repro/kernels/farfield.py:97",
        "launches": (tree["launches_main_per_batch"]
                     + resumed["bh_interaction"]),
        "launches_from": "the default EE and t-SNE tree fits and the EE "
                         "tree fit stopped and resumed (phase resume)",
        "yardstick_launches": tree["launches_per_batch"],
        "yardstick_launches_from": "the EE and t-SNE tree fits rerun for 3 "
                                   "iterations through the per-batch path "
                                   "(_tree_repulsion_batched)",
        **kernel_numbers(timing_bh["near chunk", "float32"]),
        **tuned_numbers(tuned, None)})
    # the fused cell interaction, one launch an evaluation of the default
    # tree fits, over the t-SNE tree fit's whole evaluation, float32
    if tree["launches"] < 1:
        raise AssertionError("the default tree fits launched no fused "
                             "cell-interaction kernel")
    kernels.append({
        "name": "bh_tree", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/farfield.cu",
        "replaces": "src/repro/kernels/farfield.py:97",
        "launches": tree["launches"] + resumed["bh_tree"],
        "launches_from": "the default EE and t-SNE tree fits and the EE "
                         "tree fit stopped and resumed (phase resume)",
        **kernel_numbers(timing_bh["fused", "float32"]),
        **tuned_numbers(tuned, next(t for t in tuned
                                    if t.startswith("bh_tree tsne")
                                    and t.endswith("float32")))})
    # the local-rows kernel at the main path's shape on this one card (one
    # rank, nb = N) on the EE fit's reverse graph, float32, as rows 2 and 3
    if sharded["launches"] < 1:
        raise AssertionError("the sharded fits launched no local-rows "
                             "kernel")
    kernels.append({
        "name": "ell_lap_matvec_local", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ell.cu",
        "replaces": "src/repro/kernels/sparse_attractive.py:241",
        "launches": sharded["launches"] + resumed["ell_lap_matvec_local"],
        "launches_from": "the one-rank EE and t-SNE sparse-sharded fits and "
                         "the t-SNE one stopped and resumed (phase "
                         "resume)",
        **kernel_numbers(timing_local["reverse", N_SPARSE, "float32"]),
        **tuned_numbers(tuned, f"ell_local reverse k="
                               f"{sharded['fits']['ee'].affinities_.rev.k} "
                               f"nb={N_SPARSE} row0=0 float32")})
    from repro_torch.kernels import autotune
    say("done", f"autotune: {autotune.n_searches} searches in this run; "
                f"their kernel launches, apart from the kernels line's: "
                f"{dict(sorted(autotune.search_launches.items()))}")
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
