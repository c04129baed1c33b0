"""Kernel dispatch: the one entry point for the fused pairwise terms.

Port of the `pairwise_terms` part of `repro/kernels/ops.py`.  The rest of
the port calls `pairwise_terms`; it decides per call:

  1. **Path**, by the `impl` knob: ``"auto"`` runs the CUDA kernel on CUDA
     tensors and the PyTorch oracle on CPU tensors; ``"kernel"`` runs the
     kernel and raises for CPU tensors; ``"torch"`` runs the oracle on any
     device (the yardstick the kernel is measured against).
  2. **Precision**: ``storage_dtype="bfloat16"`` rounds X, Wa and Wb
     through bfloat16 (as `repro`'s `_maybe_bf16` does), on both paths, so
     the kernel and the oracle see the same quantization.  Accumulation is
     float32 and outputs are float32.

The TPU layout steps of the reference (padding d to 128 lanes and N to a
tile multiple) have no counterpart: the kernel takes any d and masks the
ragged edge itself.

Every decision is recorded: `last_dispatch("pairwise_terms")` returns the
most recent one as a dict of path, reason and storage.
"""
from __future__ import annotations

import torch

from .pairwise import pairwise_terms_cuda
from .ref import KINDS, PairwiseTerms, pairwise_terms_ref

IMPLS = ("auto", "kernel", "torch")
STORAGE_DTYPES = ("float32", "bfloat16")
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_LAST: dict[str, dict] = {}


def last_dispatch(kernel: str | None = None):
    """The most recent dispatch decision (dict of path/reason/storage), per
    kernel or the whole registry."""
    return dict(_LAST) if kernel is None else _LAST.get(kernel)


def resolve_storage(storage_dtype: str | None) -> str:
    name = storage_dtype or "float32"
    if name not in STORAGE_DTYPES:
        raise ValueError(f"unsupported storage_dtype {storage_dtype!r}; "
                         f"have {STORAGE_DTYPES}")
    return name


def to_storage(x: torch.Tensor, storage: str) -> torch.Tensor:
    """x in the storage dtype, contiguous; no copy when it already is."""
    return x.to(_TORCH_DTYPE[storage]).contiguous()


def pairwise_terms(X: torch.Tensor, Wa: torch.Tensor, Wb: torch.Tensor,
                   kind: str, *, impl: str = "auto",
                   storage_dtype: str | None = None) -> PairwiseTerms:
    """Fused pairwise terms; see kernels/ref.py for the contract."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")
    storage = resolve_storage(storage_dtype)
    if impl == "torch" or (impl == "auto" and not X.is_cuda):
        reason = "forced-off" if impl == "torch" else "cpu-tensor"
        _LAST["pairwise_terms"] = {"path": "torch", "reason": reason,
                                   "storage": storage}
        Xs, Was, Wbs = (to_storage(t, storage).float() for t in (X, Wa, Wb))
        return pairwise_terms_ref(Xs, Was, Wbs, kind)
    if not X.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; X is on "
                         f"{X.device}")
    reason = "cuda-default" if impl == "auto" else "forced-on"
    _LAST["pairwise_terms"] = {"path": "kernel", "reason": reason,
                               "storage": storage}
    return pairwise_terms_cuda(to_storage(X, storage), to_storage(Wa, storage),
                               to_storage(Wb, storage), kind)
