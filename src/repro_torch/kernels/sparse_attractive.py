"""Wrapper of the CUDA ELL Laplacian kernels (csrc/ell.cu).

`ell_lap_matvec_cuda` is the port of `repro/kernels/sparse_attractive.py`'s
`ell_lap_matvec_pallas` (layout ``"vmem"``) and `ell_lap_matvec_pallas_hbm`
(layout ``"hbm"``): the contract of `ref.ell_lap_matvec_ref`, computed by a
hand-written Hopper kernel.  It takes CUDA tensors only and launches the
kernel or raises; the CPU path and the choice between the two live in
`ops.ell_lap_matvec`.

`launch_counts["ell_lap_matvec_vmem"]` and `["ell_lap_matvec_hbm"]` grow by
one for every launch of that layout, so a run can show that its main path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LAYOUTS = ("vmem", "hbm")

#: kernel launches in this process, by kernel name
launch_counts: dict[str, int] = {f"ell_lap_matvec_{lay}": 0
                                 for lay in LAYOUTS}

STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("ell")
        fn = lib.ell_lap_matvec_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(X: torch.Tensor, indices: torch.Tensor,
           weights: torch.Tensor) -> None:
    for name, t in (("X", X), ("indices", indices), ("weights", weights)):
        if not t.is_cuda:
            raise ValueError(
                f"ell_lap_matvec_cuda needs CUDA tensors; {name} is on "
                f"{t.device} (ops.ell_lap_matvec runs the oracle on CPU)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.device != X.device:
            raise ValueError(f"{name} must be on X's device")
    if X.dtype not in STORAGE:
        raise TypeError(f"X has dtype {X.dtype}; the kernel takes float32 "
                        f"or bfloat16 storage")
    if weights.dtype != X.dtype:
        raise TypeError(f"weights have dtype {weights.dtype}; they must "
                        f"share X's storage dtype {X.dtype}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices have dtype {indices.dtype}; the kernel "
                        f"takes int32")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X must be (N, d) with N, d >= 1, got "
                         f"{tuple(X.shape)}")
    if (indices.dim() != 2 or indices.shape[0] != X.shape[0]
            or indices.shape[1] < 1):
        raise ValueError(f"indices must be ({X.shape[0]}, k) with k >= 1, "
                         f"got {tuple(indices.shape)}")
    if tuple(weights.shape) != tuple(indices.shape):
        raise ValueError(f"weights must match indices' shape "
                         f"{tuple(indices.shape)}, got "
                         f"{tuple(weights.shape)}")


def ell_lap_matvec_cuda(X: torch.Tensor, indices: torch.Tensor,
                        weights: torch.Tensor, *, layout: str = "vmem"
                        ) -> torch.Tensor:
    """L(A) X (ref.py contract) by the CUDA kernel of the given layout.

    X (N, d) and weights (N, k): contiguous CUDA tensors of one storage
    dtype (float32 or bfloat16); indices (N, k) int32 in [0, N).  Returns
    float32 (N, d), enqueued on the current stream."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")
    _check(X, indices, weights)
    n, d = X.shape
    k = indices.shape[1]
    lib = _lib()
    out = torch.empty((n, d), dtype=torch.float32, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    status = lib.ell_lap_matvec_launch(
        X.data_ptr(), indices.data_ptr(), weights.data_ptr(), n, d, k, 0, n,
        STORAGE[X.dtype], LAYOUTS.index(layout), out.data_ptr(), stream)
    if status != 0:
        raise RuntimeError(
            f"ell_lap_matvec kernel launch failed: CUDA error {status} "
            f"(n={n}, d={d}, k={k}, layout={layout!r}; the hbm layout "
            f"stages 2 x rows-a-chunk x k neighbour rows in shared memory "
            f"and refuses a k too wide for it)")
    launch_counts[f"ell_lap_matvec_{layout}"] += 1
    return out
