"""Wrapper of the CUDA Barnes-Hut cell-interaction kernel (csrc/farfield.cu).

`bh_interaction_cuda` is the port of `repro/kernels/farfield.py::
bh_interaction_pallas`: the contract of `ref.bh_interaction_ref`, computed
by a hand-written Hopper kernel.  It takes CUDA tensors only and launches
the kernel or raises; the CPU path lives in `ops.bh_interaction`.

`launch_counts["bh_interaction"]` grows by one for every launch, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import KINDS

#: kernel launches in this process, by kernel name
launch_counts: dict[str, int] = {"bh_interaction": 0}

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
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
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


def bh_interaction_cuda(X: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        table: torch.Tensor, kind: str
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(s (N,), F (N, d)) of the ref.py contract by the CUDA kernel.

    X (N, d) and table (M, d): contiguous CUDA tensors of one storage dtype
    (float32 or bfloat16), d <= 4; idx (N, W) int32 with entries in [0, M)
    and w (N, W) float32, each with unit column stride.  Outputs are float32,
    enqueued on the current stream."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check(X, idx, w, table)
    n, d = X.shape
    width = idx.shape[1]
    lib = _lib()
    s = torch.empty((n,), dtype=torch.float32, device=X.device)
    F = torch.empty((n, d), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    status = lib.bh_interaction_launch(
        X.data_ptr(), idx.data_ptr(), idx.stride(0), w.data_ptr(),
        w.stride(0), table.data_ptr(), n, table.shape[0], d, width,
        KINDS.index(kind), STORAGE[X.dtype], s.data_ptr(), F.data_ptr(),
        stream)
    if status != 0:
        raise RuntimeError(f"bh_interaction kernel launch failed: CUDA error "
                           f"{status} (n={n}, d={d}, width={width}, "
                           f"kind={kind!r})")
    launch_counts["bh_interaction"] += 1
    return s, F
