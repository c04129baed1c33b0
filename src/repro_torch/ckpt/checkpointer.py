"""Checkpointing of a pytree of tensors and arrays.

Port of `repro/ckpt/checkpointer.py`, with the same layout on disk, so that
each package restores what the other saved, bit for bit:

  * atomic: a step is written into a temporary directory, its manifest
    fsync'ed, and the directory renamed to ``step_%012d``; a crash mid-save
    never corrupts the latest checkpoint;
  * integrity-checked: ``manifest.json`` records each leaf's shape, dtype
    and the first 16 hex digits of its SHA-256, and `restore` verifies every
    leaf before it returns;
  * keep-k GC and auto-resume from the newest complete step
    (`latest_step`, `restore_latest`); `async_save` writes on a thread
    after the device-to-host copy.

A pytree here is what `jax.tree_util` flattens by default: dicts (keys in
sorted order), lists and tuples (named tuples too) are nodes, None has no
leaves, and everything else is a leaf, so that a dict of arrays numbers its
``arr_<i>.npy`` leaves as the reference does.  Tensors go to numpy through
``.detach().cpu()``; a bfloat16 leaf raises (numpy has no such dtype).
Leaves are stored in their logical (whole) layout: a sharded fit saves its
replicated arrays, and any rank can restore them.  Under an active
telemetry tracer (`repro_torch.obs`) a save runs the spans
``checkpoint/device-to-host``, ``checkpoint/write`` (the ``.npy`` files)
and ``checkpoint/hash``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs import span


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any) -> tuple[list, Callable[[list], Any], str]:
    """(leaves, rebuild, treedef) of `tree`, in `jax.tree_util`'s order;
    `rebuild(new_leaves)` makes the same structure around new leaves and
    `treedef` is the structure as the reference's manifest writes it."""
    if tree is None:
        return [], lambda leaves: None, "None"
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        spec = "{" + ", ".join(f"{k!r}: {p[2]}"
                               for k, p in zip(keys, parts)) + "}"
        return (*_join(parts, lambda vals: dict(zip(keys, vals))), spec)
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        inner = ", ".join(p[2] for p in parts)
        if _is_namedtuple(tree):
            cls = type(tree)
            return (*_join(parts, lambda vals: cls(*vals)),
                    f"CustomNode(namedtuple[{cls.__name__}], [{inner}])")
        if isinstance(tree, list):
            return (*_join(parts, list), f"[{inner}]")
        return (*_join(parts, tuple),
                f"({inner}{',' if len(parts) == 1 else ''})")
    return [tree], lambda leaves: leaves[0], "*"


def _join(parts, make):
    leaves = [leaf for p in parts for leaf in p[0]]
    sizes = [len(p[0]) for p in parts]

    def rebuild(new):
        out, off = [], 0
        for (_, sub, _), size in zip(parts, sizes):
            out.append(sub(new[off:off + size]))
            off += size
        return make(out)

    return leaves, rebuild


def _host(i: int, x) -> np.ndarray:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {i} is a bfloat16 tensor, which numpy (and "
                f"so the .npy format) cannot hold; store it as float32")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _hash(arr: np.ndarray) -> str:
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()[:16]


#: threads hashing the leaves of one checkpoint (hashlib releases the GIL
#: on large buffers; one SHA-256 stream runs at ~0.6 GB/s on the H100's
#: host, PERF.md, so a 3.2 GB dense SD payload's two matrices hash in turn
#: otherwise)
HASH_THREADS = 8


def _hashes(arrays: list[np.ndarray]) -> list[str]:
    """`_hash` of each array, several arrays at a time."""
    with ThreadPoolExecutor(max_workers=HASH_THREADS) as pool:
        return list(pool.map(_hash, arrays))


def _like(example, arr: np.ndarray):
    """A restored leaf in the example leaf's kind: a tensor on the example's
    device, a python scalar of its type, else the numpy array."""
    if torch.is_tensor(example):
        return torch.from_numpy(arr).to(example.device)
    if isinstance(example, (bool, int, float)):
        return type(example)(arr.item())
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any) -> str:
        """Save a pytree at `step`; returns the checkpoint's path.  The
        device-to-host copy happens here; with `async_save` the write runs
        on a thread (one in flight at a time, `wait()` joins it)."""
        leaves, _, treedef = _flatten(tree)
        with span("checkpoint/device-to-host"):
            host_leaves = [_host(i, x) for i, x in enumerate(leaves)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, treedef),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_leaves, treedef)
        return self._path(step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}")

    def _write(self, step: int, leaves: list[np.ndarray], treedef: str):
        final = self._path(step)
        tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
        manifest = {"step": step, "treedef": f"PyTreeDef({treedef})",
                    "arrays": []}
        try:
            with span("checkpoint/write"):
                for i, arr in enumerate(leaves):
                    np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            with span("checkpoint/hash"):
                manifest["arrays"] = [
                    {"index": i, "shape": list(arr.shape),
                     "dtype": str(arr.dtype), "hash": h}
                    for i, (arr, h) in enumerate(zip(leaves,
                                                     _hashes(leaves)))]
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- load ----------------------------------------------------------------
    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, example_tree: Any) -> Any:
        """The pytree saved at `step`, in `example_tree`'s structure.  Each
        leaf comes back in its example leaf's kind: a tensor on that
        tensor's device (the saved dtype), a python scalar of that type, or
        a numpy array.  Raises ValueError when the leaf counts differ and
        IOError when a leaf's hash does not match its manifest."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, rebuild, _ = _flatten(example_tree)
        if len(manifest["arrays"]) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['arrays'])} arrays, "
                f"example tree has {len(leaves)}")
        arrays = [np.load(os.path.join(path, f"arr_{meta['index']}.npy"))
                  for meta in manifest["arrays"]]
        for meta, h in zip(manifest["arrays"], _hashes(arrays)):
            if h != meta["hash"]:
                raise IOError(f"checkpoint corruption: array "
                              f"{meta['index']} hash mismatch")
        return rebuild([_like(example, arr)
                        for example, arr in zip(leaves, arrays)])

    def restore_latest(self, example_tree: Any):
        """(step, tree) of the newest complete checkpoint, or (None, None)
        when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, example_tree)
