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
``.detach().cpu()``.  A bfloat16 leaf is saved as the reference saves an
ml_dtypes bfloat16 array: its two-byte records under the ``.npy`` descr
``'<V2'``, the manifest's dtype ``"bfloat16"``, the hash over the same
bytes; it comes back as a bfloat16 tensor.  Leaves are stored in their
logical (whole) layout, and any rank can restore them: `restore`'s
`sharding_tree` cuts each leaf into this rank's block on restore (the
elastic re-shard: the mesh need not be the one that saved).  Under an active
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
from typing import Any

import numpy as np
import torch

from repro_torch.obs import span
from repro_torch.tree import flatten as _flatten


#: the .npy descr of the reference's bfloat16 leaves (ml_dtypes' bfloat16
#: reaches numpy's writer as two-byte void records); numpy itself has no
#: bfloat16, so a host copy of one is a `np.dtype("V2")` array of its bits
BF16_DESCR = "<V2"


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2"))
        return x.numpy()
    return np.asarray(x)


def _dtype_name(arr: np.ndarray) -> str:
    """The manifest's dtype: the reference's ``str(arr.dtype)``, which
    names an ml_dtypes bfloat16 array "bfloat16"."""
    return "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)


def _save(path: str, arr: np.ndarray) -> None:
    """`np.save`, except that a bfloat16 leaf's header says ``'<V2'``, as
    the reference's files do (numpy would write ``'|V2'``): the same bytes
    on disk from either package."""
    if arr.dtype != np.dtype("V2"):
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


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


def _like(example, arr: np.ndarray, dtype: str, sharding=None):
    """A restored leaf in the example leaf's kind: a tensor on the example's
    device (bfloat16 where the manifest says so; with a `sharding`, this
    rank's block of it, cut before the upload), a python scalar of its
    type, else the numpy array."""
    if torch.is_tensor(example):
        if dtype == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(
                np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if sharding is not None:
            t = sharding.shard(t)
        return t.to(example.device)
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
            host_leaves = [_host(x) for x in leaves]
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
                    _save(os.path.join(tmp, f"arr_{i}.npy"), arr)
            with span("checkpoint/hash"):
                manifest["arrays"] = [
                    {"index": i, "shape": list(arr.shape),
                     "dtype": _dtype_name(arr), "hash": h}
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

    def restore(self, step: int, example_tree: Any,
                sharding_tree: Any = None) -> Any:
        """The pytree saved at `step`, in `example_tree`'s structure.  Each
        leaf comes back in its example leaf's kind: a tensor on that
        tensor's device (the saved dtype), a python scalar of that type, or
        a numpy array.  `sharding_tree` (optional: `example_tree`'s
        structure, or one sharding for every leaf) places each tensor leaf
        as its sharding says, this rank's block of the whole saved array
        (`distributed.sharding.NamedSharding.shard`): the elastic re-shard,
        onto whatever mesh restores.  Raises ValueError when the leaf counts
        differ and IOError when a leaf's hash does not match its
        manifest."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, rebuild, _ = _flatten(example_tree)
        if len(manifest["arrays"]) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['arrays'])} arrays, "
                f"example tree has {len(leaves)}")
        if sharding_tree is None or hasattr(sharding_tree, "shard"):
            shardings = [sharding_tree] * len(leaves)
        else:
            shardings = _flatten(sharding_tree)[0]
            if len(shardings) != len(leaves):
                raise ValueError(f"sharding_tree has {len(shardings)} "
                                 f"leaves, example tree has {len(leaves)}")
        arrays = [np.load(os.path.join(path, f"arr_{meta['index']}.npy"))
                  for meta in manifest["arrays"]]
        for meta, h in zip(manifest["arrays"], _hashes(arrays)):
            if h != meta["hash"]:
                raise IOError(f"checkpoint corruption: array "
                              f"{meta['index']} hash mismatch")
        return rebuild([_like(example, arr, meta["dtype"], sharding)
                        for example, arr, meta, sharding in zip(
                            leaves, arrays, manifest["arrays"], shardings)])

    def restore_latest(self, example_tree: Any, sharding_tree: Any = None):
        """(step, tree) of the newest complete checkpoint, or (None, None)
        when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, example_tree, sharding_tree)
