"""Wrappers of the CUDA ELL Laplacian kernels (csrc/ell.cu).

`ell_lap_matvec_cuda` is the port of `repro/kernels/sparse_attractive.py`'s
`ell_lap_matvec_pallas` (layout ``"vmem"``) and `ell_lap_matvec_pallas_hbm`
(layout ``"hbm"``): the contract of `ref.ell_lap_matvec_ref`, computed by a
hand-written Hopper kernel (the direct gather and the staged gather, which
give the same bits).  `ell_lap_matvec_local_cuda` is the port of
`ell_lap_matvec_local_pallas`: the contract of `ref.ell_lap_matvec_local_ref`
(one shard's rows against a replicated X), the row-sharded backend's
product.  Both take CUDA tensors only and launch the kernel or raise; the
CPU path lives in `ops.ell_lap_matvec` and `ops.ell_lap_matvec_local`.

`launch_counts["ell_lap_matvec_vmem"]`, `["ell_lap_matvec_hbm"]` and
`["ell_lap_matvec_local"]` grow by one for every launch of that kernel, so a
run can show that its main path went through it; launches made by an
autotune search are counted apart (`autotune.search_launches`).

The launch shape changes no bit of the outputs (csrc/ell.cu):
`block_rows` rows a block and `chunk`, for "vmem" and the local-rows kernel
P, a lane's slots a pass, for "hbm" the span a warp walks in row groups;
None takes the fixed shape (each list of `autotune.ell_candidates` starts
with it).  `kernels.autotune` searches it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .autotune import count_launch
from .ref import check_local_rows

LAYOUTS = ("vmem", "hbm")

#: kernel launches in this process, by kernel name
launch_counts: dict[str, int] = {f"ell_lap_matvec_{lay}": 0
                                 for lay in (*LAYOUTS, "local")}

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
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.ell_lap_matvec_local_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(X: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor,
           n_rows: int | None = None, fn: str = "ell_lap_matvec") -> None:
    """Device, layout and type checks; `indices` must have `n_rows` rows
    (default: X's)."""
    n_rows = X.shape[0] if n_rows is None else n_rows
    for name, t in (("X", X), ("indices", indices), ("weights", weights)):
        if not t.is_cuda:
            raise ValueError(
                f"{fn}_cuda needs CUDA tensors; {name} is on {t.device} "
                f"(ops.{fn} runs the oracle on CPU)")
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
    if (indices.dim() != 2 or indices.shape[0] != n_rows
            or indices.shape[1] < 1):
        raise ValueError(f"indices must be ({n_rows}, k) with k >= 1, "
                         f"got {tuple(indices.shape)}")
    if tuple(weights.shape) != tuple(indices.shape):
        raise ValueError(f"weights must match indices' shape "
                         f"{tuple(indices.shape)}, got "
                         f"{tuple(weights.shape)}")


def ell_launcher(X: torch.Tensor, indices: torch.Tensor,
                 weights: torch.Tensor, *, layout: str = "vmem",
                 block_rows: int | None = None, chunk: int | None = None):
    """Check the inputs once and allocate the output: (launch, out), where
    each `launch()` enqueues the kernel of `layout` on the current stream of
    X's device (writing `out` again) and raises if the launch fails.
    `ell_lap_matvec_cuda` launches it once; an autotune search times it."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")
    _check(X, indices, weights)
    n, d = X.shape
    k = indices.shape[1]
    lib = _lib()
    out = torch.empty((n, d), dtype=torch.float32, device=X.device)
    args = (X.data_ptr(), indices.data_ptr(), weights.data_ptr(), n, d, k,
            STORAGE[X.dtype], LAYOUTS.index(layout), block_rows or 0,
            chunk or 0, out.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream)
    name = f"ell_lap_matvec_{layout}"

    def launch() -> None:
        status = lib.ell_lap_matvec_launch(*args)
        if status != 0:
            raise RuntimeError(
                f"ell_lap_matvec kernel launch failed: CUDA error {status} "
                f"(n={n}, d={d}, k={k}, layout={layout!r}, "
                f"block_rows={block_rows}, chunk={chunk}; neither layout "
                f"limits k: the hbm layout's shared-memory rings hold a "
                f"fixed number of slots a lane, whatever the row width)")
        count_launch(launch_counts, name)

    return launch, out


def ell_lap_matvec_cuda(X: torch.Tensor, indices: torch.Tensor,
                        weights: torch.Tensor, *, layout: str = "vmem",
                        block_rows: int | None = None,
                        chunk: int | None = None) -> torch.Tensor:
    """L(A) X (ref.py contract) by the CUDA kernel of the given layout.

    X (N, d) and weights (N, k): contiguous CUDA tensors of one storage
    dtype (float32 or bfloat16); indices (N, k) int32 in [0, N).
    `block_rows` and `chunk` set the launch shape (module docstring; None:
    the fixed shape); a shape out of range raises.  Returns float32 (N, d),
    enqueued on the current stream."""
    launch, out = ell_launcher(X, indices, weights, layout=layout,
                               block_rows=block_rows, chunk=chunk)
    launch()
    return out


def ell_local_launcher(X_rep: torch.Tensor, indices: torch.Tensor,
                       weights: torch.Tensor, row0: int, *,
                       block_rows: int | None = None,
                       chunk: int | None = None):
    """(launch, out) of the local-rows kernel, as `ell_launcher`."""
    if indices.dim() != 2:
        raise ValueError(f"indices must be (nb, k), got "
                         f"{tuple(indices.shape)}")
    nb = indices.shape[0]
    _check(X_rep, indices, weights, n_rows=nb, fn="ell_lap_matvec_local")
    n_x, d = X_rep.shape
    check_local_rows(n_x, nb, row0)
    k = indices.shape[1]
    lib = _lib()
    out = torch.empty((nb, d), dtype=torch.float32, device=X_rep.device)
    args = (X_rep.data_ptr(), indices.data_ptr(), weights.data_ptr(), n_x, d,
            k, row0, nb, STORAGE[X_rep.dtype], block_rows or 0, chunk or 0,
            out.data_ptr(), torch.cuda.current_stream(X_rep.device).cuda_stream)

    def launch() -> None:
        status = lib.ell_lap_matvec_local_launch(*args)
        if status != 0:
            raise RuntimeError(
                f"ell_lap_matvec_local kernel launch failed: CUDA error "
                f"{status} (n_x={n_x}, nb={nb}, row0={row0}, d={d}, k={k}, "
                f"block_rows={block_rows}, chunk={chunk})")
        count_launch(launch_counts, "ell_lap_matvec_local")

    return launch, out


def ell_lap_matvec_local_cuda(X_rep: torch.Tensor, indices: torch.Tensor,
                              weights: torch.Tensor, row0: int, *,
                              block_rows: int | None = None,
                              chunk: int | None = None) -> torch.Tensor:
    """Rows [row0, row0 + nb) of L(A) X (ref.ell_lap_matvec_local_ref
    contract) by the local-rows CUDA kernel.

    X_rep (n_x, d), the replicated X, and weights (nb, k): contiguous CUDA
    tensors of one storage dtype (float32 or bfloat16); indices (nb, k)
    int32, global ids in [0, n_x), unchecked as in `ell_lap_matvec_cuda`
    (the sharded backend checks its graph once, in
    `sparse.sharding.shard_sparse_affinities`); 1 <= nb <= n_x and
    0 <= row0 <= n_x - nb.  `block_rows` and `chunk` set the launch shape
    as for "vmem".  Returns float32 (nb, d), enqueued on the current
    stream."""
    launch, out = ell_local_launcher(X_rep, indices, weights, row0,
                                     block_rows=block_rows, chunk=chunk)
    launch()
    return out
