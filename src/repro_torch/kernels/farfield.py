"""Wrappers of the CUDA Barnes-Hut kernels (csrc/farfield.cu).

Both port `repro/kernels/farfield.py::bh_interaction_pallas`.
`bh_interaction_cuda` keeps its contract, `ref.bh_interaction_ref`: one
materialised (N, W) batch a call.  `bh_tree_cuda` is the Hopper design of
it, `ref.bh_tree_ref`: one whole tree evaluation a launch, every slot
derived from the grid state (`ref.TreeGrid`) in registers.  They take CUDA
tensors only and launch their kernel or raise; the CPU paths live in
`ops.bh_interaction` and `ops.bh_tree`.

`launch_counts["bh_interaction"]` and `launch_counts["bh_tree"]` grow by one
for every launch, so a run can show which kernel its main path went
through; launches made by an autotune search are counted apart
(`autotune.search_launches`).

The launch shape, `block_rows` rows a block (None: 256 / S of them for
`bh_interaction_cuda`, 8 for the fused kernel), changes no bit of the
outputs (csrc/farfield.cu); `kernels.autotune` searches it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .autotune import count_launch
from .ref import KINDS, TreeGrid

#: kernel launches in this process, by kernel name
launch_counts: dict[str, int] = {"bh_interaction": 0, "bh_tree": 0}

STORAGE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 4            # d is a template parameter of the kernel up to this

_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("farfield")
        fn = lib.bh_interaction_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.bh_tree_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 10
                       + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
           table: torch.Tensor) -> None:
    for name, t in (("X", X), ("idx", idx), ("w", w), ("table", table)):
        if not t.is_cuda:
            raise ValueError(
                f"bh_interaction_cuda needs CUDA tensors; {name} is on "
                f"{t.device} (ops.bh_interaction runs the oracle on CPU)")
        if t.device != X.device:
            raise ValueError(f"{name} must be on X's device")
    if X.dtype not in STORAGE:
        raise TypeError(f"X has dtype {X.dtype}; the kernel takes float32 "
                        f"or bfloat16 storage")
    if table.dtype != X.dtype:
        raise TypeError(f"table has dtype {table.dtype}; it must share X's "
                        f"storage dtype {X.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w has dtype {w.dtype}; the kernel takes float32 "
                        f"slot weights (they carry cell occupancies)")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx has dtype {idx.dtype}; the kernel takes int32")
    if X.dim() != 2 or X.shape[0] < 1 or not 1 <= X.shape[1] <= MAX_D:
        raise ValueError(f"X must be (N, d) with N >= 1 and 1 <= d <= "
                         f"{MAX_D}, got {tuple(X.shape)}")
    n, d = X.shape
    if table.dim() != 2 or table.shape[0] < 1 or table.shape[1] != d:
        raise ValueError(f"table must be (M, {d}) with M >= 1, got "
                         f"{tuple(table.shape)}")
    if idx.dim() != 2 or idx.shape[0] != n or idx.shape[1] < 1:
        raise ValueError(f"idx must be ({n}, W) with W >= 1, got "
                         f"{tuple(idx.shape)}")
    if tuple(w.shape) != tuple(idx.shape):
        raise ValueError(f"w must match idx's shape {tuple(idx.shape)}, got "
                         f"{tuple(w.shape)}")
    for name, t in (("X", X), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("idx", idx), ("w", w)):
        if t.stride(1) != 1:
            raise ValueError(f"{name} must have unit column stride (rows may "
                             f"be a column slice of a wider batch)")


def bh_launcher(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                table: torch.Tensor, kind: str, *,
                block_rows: int | None = None):
    """Check the inputs once and allocate the outputs: (launch, (s, F)),
    where each `launch()` enqueues the kernel on the current stream of X's
    device (writing s and F again) and raises if the launch fails.
    `bh_interaction_cuda` launches it once; an autotune search times it."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check(X, idx, w, table)
    n, d = X.shape
    width = idx.shape[1]
    lib = _lib()
    s = torch.empty((n,), dtype=torch.float32, device=X.device)
    F = torch.empty((n, d), dtype=torch.float32, device=X.device)
    args = (X.data_ptr(), idx.data_ptr(), idx.stride(0), w.data_ptr(),
            w.stride(0), table.data_ptr(), n, table.shape[0], d, width,
            KINDS.index(kind), STORAGE[X.dtype], block_rows or 0,
            s.data_ptr(), F.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream)

    def launch() -> None:
        status = lib.bh_interaction_launch(*args)
        if status != 0:
            raise RuntimeError(
                f"bh_interaction kernel launch failed: CUDA error {status} "
                f"(n={n}, d={d}, width={width}, kind={kind!r}, "
                f"block_rows={block_rows})")
        count_launch(launch_counts, "bh_interaction")

    return launch, (s, F)


def bh_interaction_cuda(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        table: torch.Tensor, kind: str, *,
                        block_rows: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s (N,), F (N, d)) of the ref.py contract by the CUDA kernel.

    X (N, d) and table (M, d): contiguous CUDA tensors of one storage dtype
    (float32 or bfloat16), d <= 4; idx (N, W) int32 with entries in [0, M)
    and w (N, W) float32, each with unit column stride.  `block_rows` rows a
    block (block_rows x S threads a multiple of 32 up to 512; None: 256
    threads); a shape out of range raises.  Outputs are float32, enqueued on
    the current stream."""
    launch, out = bh_launcher(X, idx, w, table, kind, block_rows=block_rows)
    launch()
    return out


def _check_tree(grid: TreeGrid) -> None:
    Xs = grid.Xs
    tensors = {"Xs": Xs, "perm": grid.perm, "cids": grid.cids,
               "starts": grid.starts, "counts": grid.counts,
               "res_cnt": grid.res_cnt, "res_com": grid.res_com,
               "far_offsets": grid.far_offsets,
               "near_offsets": grid.near_offsets,
               **{f"level_counts[{i}]": t
                  for i, t in enumerate(grid.level_counts)},
               **{f"level_com[{i}]": t for i, t in enumerate(grid.level_com)}}
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"bh_tree_cuda needs CUDA tensors; {name} is on {t.device} "
                f"(ops.bh_tree runs the oracle on CPU)")
        if t.device != Xs.device:
            raise ValueError(f"{name} must be on Xs's device")
    if Xs.dtype not in STORAGE:
        raise TypeError(f"Xs has dtype {Xs.dtype}; the kernel takes float32 "
                        f"or bfloat16 storage")
    for name, t in (("res_com", grid.res_com),
                    *((f"level_com[{i}]", t)
                      for i, t in enumerate(grid.level_com))):
        if t.dtype != Xs.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; it must share Xs's "
                            f"storage dtype {Xs.dtype}")
    if Xs.dim() != 2 or Xs.shape[1] != 2:
        raise ValueError(f"Xs must be (N, 2): the tree is 2-D (d = 2 only), "
                         f"got {tuple(Xs.shape)}")
    if grid.r < 1:
        raise ValueError("theta = 0 (exhaustive mode) has no grid; it runs "
                         "the per-batch kernel (bh_interaction_cuda)")
    n, D = Xs.shape[0], grid.depth
    if not 1 <= grid.l1 <= D <= 14 or grid.cap < 1 or grid.chunk < 1:
        raise ValueError(f"bad plan constants: l1={grid.l1}, depth={D}, "
                         f"cap={grid.cap}, chunk={grid.chunk}")
    if len(grid.level_counts) != D - grid.l1 + 1 or len(grid.level_com) != (
            D - grid.l1 + 1):
        raise ValueError(f"need one count and one centre-of-mass table a "
                         f"level l1..depth = {grid.l1}..{D}")
    shapes = {"perm": (n,), "cids": (n,), "starts": (4 ** D,),
              "counts": (4 ** D,), "res_cnt": (4 ** D,),
              "res_com": (4 ** D, 2),
              "near_offsets": ((2 * grid.r + 1) ** 2, 2),
              **{f"level_counts[{i}]": (4 ** (grid.l1 + i),)
                 for i in range(len(grid.level_counts))},
              **{f"level_com[{i}]": (4 ** (grid.l1 + i), 2)
                 for i in range(len(grid.level_com))}}
    for name, shape in shapes.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    far = grid.far_offsets
    if far.dim() != 2 or far.shape[0] < 1 or far.shape[1] != 2:
        raise ValueError(f"far_offsets must be (Wf, 2), got {tuple(far.shape)}")


@dataclasses.dataclass(frozen=True)
class TreeArgs:
    """A grid state as the fused kernel reads it: int32 integers, the far
    levels' tables concatenated, everything contiguous (`pack_tree`)."""

    Xs: torch.Tensor
    cids: torch.Tensor
    perm: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    lvl_counts: torch.Tensor
    lvl_com: torch.Tensor
    res_cnt: torch.Tensor
    res_com: torch.Tensor
    far: torch.Tensor
    near: torch.Tensor
    depth: int
    l1: int
    r: int
    cap: int
    chunk: int
    n_batches: int


def pack_tree(grid: TreeGrid) -> TreeArgs:
    """Check a grid state and lay it out for `launch_tree`.  grid.Xs (N, 2),
    grid.level_com and grid.res_com share one storage dtype (float32 or
    bfloat16); its integer tensors may be of any integer dtype."""
    _check_tree(grid)

    def i32(t):
        return t.to(torch.int32).contiguous()

    return TreeArgs(
        Xs=grid.Xs.contiguous(), cids=i32(grid.cids), perm=i32(grid.perm),
        starts=i32(grid.starts), counts=i32(grid.counts),
        lvl_counts=i32(torch.cat(grid.level_counts)),
        lvl_com=torch.cat(grid.level_com).contiguous(),
        res_cnt=i32(grid.res_cnt), res_com=grid.res_com.contiguous(),
        far=i32(grid.far_offsets), near=i32(grid.near_offsets),
        depth=grid.depth, l1=grid.l1, r=grid.r, cap=grid.cap,
        chunk=grid.chunk, n_batches=grid.n_batches)


def tree_launcher(a: TreeArgs, kind: str, *, block_rows: int | None = None):
    """Allocate the fused kernel's outputs for a packed grid state:
    (launch, (s_rows, F)), where each `launch()` enqueues the kernel on the
    current stream of Xs's device and raises if the launch fails.
    `launch_tree` launches it once; an autotune search times it."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    n = a.Xs.shape[0]
    ld = -(-n // 128) * 128
    s_rows = torch.empty((a.n_batches, ld), dtype=torch.float32,
                         device=a.Xs.device)
    F = torch.empty((n, 2), dtype=torch.float32, device=a.Xs.device)
    lib = _lib()
    args = (a.Xs.data_ptr(), a.cids.data_ptr(), a.perm.data_ptr(),
            a.starts.data_ptr(), a.counts.data_ptr(), a.lvl_counts.data_ptr(),
            a.lvl_com.data_ptr(), a.res_cnt.data_ptr(), a.res_com.data_ptr(),
            a.far.data_ptr(), a.far.shape[0], a.near.data_ptr(),
            a.near.shape[0], n, a.depth, a.l1, a.r, a.cap, a.chunk,
            KINDS.index(kind), STORAGE[a.Xs.dtype], block_rows or 0,
            s_rows.data_ptr(), ld, F.data_ptr(),
            torch.cuda.current_stream(a.Xs.device).cuda_stream)

    def launch() -> None:
        status = lib.bh_tree_launch(*args)
        if status != 0:
            raise RuntimeError(
                f"bh_tree kernel launch failed: CUDA error {status} (n={n}, "
                f"depth={a.depth}, r={a.r}, cap={a.cap}, kind={kind!r}, "
                f"block_rows={block_rows})")
        count_launch(launch_counts, "bh_tree")

    return launch, (s_rows[:, :n], F)


def launch_tree(a: TreeArgs, kind: str, *, block_rows: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the fused kernel on a packed grid state: (s_rows
    (n_batches, N), F (N, 2)), float32, in point order, enqueued on the
    current stream.  s_rows is a view of a buffer whose rows start 512-byte
    aligned, as a fresh (N,) tensor does, so that a reduction over a row
    runs as over one; F is contiguous.  `block_rows` rows (a warp each) a
    block, 1 to 16 (None: 8); a shape out of range raises."""
    launch, out = tree_launcher(a, kind, block_rows=block_rows)
    launch()
    return out


def bh_tree_cuda(grid: TreeGrid, kind: str, *, block_rows: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s_rows (n_batches, N), F (N, 2)) of the `ref.bh_tree_ref` contract
    by one launch of the fused kernel (`pack_tree`, then `launch_tree`)."""
    return launch_tree(pack_tree(grid), kind, block_rows=block_rows)
