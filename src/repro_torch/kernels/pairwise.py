"""Wrapper of the CUDA pairwise kernel (csrc/pairwise.cu).

`pairwise_terms_cuda` is the port of `repro/kernels/pairwise.py::
pairwise_terms_pallas`: the same contract as `ref.pairwise_terms_ref`,
computed by the hand-written Hopper kernel.  It takes CUDA tensors only and
launches the kernel or raises; the CPU path and the choice between the two
live in `ops.pairwise_terms`.

`launch_counts["pairwise_terms"]` grows by one for every launch, so a run
can show that its main path went through the kernel; launches made by an
autotune search are counted apart (`autotune.search_launches`).

The launch shape (`block_rows` rows a block, `block_cols` X columns staged
a tile; None: the fixed 8 and 1024) changes no bit of the outputs
(csrc/pairwise.cu); `kernels.autotune` searches it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .autotune import count_launch
from .ref import KINDS, PairwiseTerms

#: kernel launches in this process, by kernel name
launch_counts: dict[str, int] = {"pairwise_terms": 0}

STORAGE = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("pairwise")
        fn = lib.pairwise_terms_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(X: torch.Tensor, Wa: torch.Tensor, Wb: torch.Tensor) -> None:
    for name, t in (("X", X), ("Wa", Wa), ("Wb", Wb)):
        if not t.is_cuda:
            raise ValueError(
                f"pairwise_terms_cuda needs CUDA tensors; {name} is on "
                f"{t.device} (ops.pairwise_terms runs the oracle on CPU)")
        if t.dtype not in STORAGE:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"float32 or bfloat16 storage")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"X must be (N, d) with N, d >= 1, got "
                         f"{tuple(X.shape)}")
    n = X.shape[0]
    for name, t in (("Wa", Wa), ("Wb", Wb)):
        if tuple(t.shape) != (n, n):
            raise ValueError(f"{name} must be ({n}, {n}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != X.dtype or t.device != X.device:
            raise ValueError(f"{name} must share X's dtype and device")


def pairwise_launcher(X: torch.Tensor, Wa: torch.Tensor, Wb: torch.Tensor,
                      kind: str, *, block_rows: int | None = None,
                      block_cols: int | None = None):
    """Check the inputs once and allocate the outputs: (launch, terms),
    where each `launch()` enqueues the kernel on the current stream of
    X's device (writing `terms` again) and raises if the launch fails.
    `pairwise_terms_cuda` launches it once; an autotune search times it."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    _check(X, Wa, Wb)
    n, d = X.shape
    lib = _lib()
    la = torch.empty((n, d), dtype=torch.float32, device=X.device)
    lb = torch.empty_like(la)
    partials = torch.empty(2 * n, dtype=torch.float32, device=X.device)
    out = torch.empty(2, dtype=torch.float32, device=X.device)
    args = (X.data_ptr(), Wa.data_ptr(), Wb.data_ptr(), n, d,
            KINDS.index(kind), STORAGE[X.dtype], block_rows or 0,
            block_cols or 0, la.data_ptr(), lb.data_ptr(),
            partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream)

    def launch() -> None:
        status = lib.pairwise_terms_launch(*args)
        if status != 0:
            raise RuntimeError(
                f"pairwise_terms kernel launch failed: CUDA error {status} "
                f"(n={n}, d={d}, kind={kind!r}, block_rows={block_rows}, "
                f"block_cols={block_cols})")
        count_launch(launch_counts, "pairwise_terms")

    return launch, PairwiseTerms(la_x=la, lb_x=lb, e_plus=out[0], s=out[1])


def pairwise_terms_cuda(X: torch.Tensor, Wa: torch.Tensor, Wb: torch.Tensor,
                        kind: str, *, block_rows: int | None = None,
                        block_cols: int | None = None) -> PairwiseTerms:
    """L(a)X, L(b)X, e_plus and s (ref.py contract) by the CUDA kernel.

    X, Wa, Wb: contiguous CUDA tensors of one storage dtype (float32 or
    bfloat16); outputs are float32.  `block_rows` (1-16) and `block_cols`
    (a multiple of 128 in float32, of 256 in bfloat16, whose min(d, 4)
    float columns fit in 48 KB) set the launch shape; None takes the fixed
    8 and 1024.  A shape out of range raises.  Enqueued on the current
    stream."""
    launch, terms = pairwise_launcher(X, Wa, Wb, kind, block_rows=block_rows,
                                      block_cols=block_cols)
    launch()
    return terms
