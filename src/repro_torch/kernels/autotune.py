"""At-first-dispatch autotuner for the Hopper kernels' launch shapes.

Port of `repro/kernels/autotune.py`: the small search harness that
`kernels/ops.py` consults whenever a caller leaves a kernel's launch shape
unset.

  * a **candidate list** of `KernelConfig`s is generated per kernel
    (`pairwise_candidates`, `ell_candidates`, `bh_candidates`,
    `bh_tree_candidates`); the fixed shape that the kernels launched
    before the autotuner is always the first candidate, so a tuned pick
    loses to it only by noise, and it is the fallback;
  * each candidate is **timed** by CUDA events around a few launches a
    rep, best of `reps` after one warm-up launch (a launch of ~50 us is
    near the host's own cost of issuing it, so a wall clock around each
    launch would rank the host, not the kernel); candidates whose launch
    fails score `inf`;
  * the winner is cached **in-process** under a key of (kernel, shape
    bucket, k, d, dtype, device kind, mode) and optionally **on disk**:
    point `REPRO_AUTOTUNE_CACHE` at a JSON file and every process that
    shares it skips the search.  The file is the reference's (`"version":
    1`, `"entries"`), rewritten as a merge so that entries of other
    devices and of the JAX package survive.

**Every candidate gives the same bits.**  A candidate may change only what
leaves each output's sum order as it is: rows a block (a row is summed by
its own warp or group of lanes whatever the block), the pairwise kernel's
staged tile width (a multiple of its lanes' column stride), the ELL direct
gather's slots a pass P (the sum order follows the lanes a row, S, not P)
and the staged gather's warps a block and span (it adds slots in the
direct gather's order); csrc/*.cu say why for each.  Nothing that sets a
sum order (S, the Barnes-Hut `chunk`) is searched.  So two ranks that
search on their own, or a resumed fit in a process that searched again,
compute what the first run computed, bit for bit.

The fields of `KernelConfig` on Hopper:

  * `block_rows`: rows a block.  Pairwise and the fused tree kernel: warps
    a block (a warp a row).  The ELL direct gather ("vmem", local) and the
    per-batch Barnes-Hut kernel: threads a block / S.  The staged gather
    ("hbm"): warps a block x span x 32 / S.
  * `block_cols`: the pairwise kernel's X columns staged a tile (0 for the
    others).
  * `layout`: the caller's ("vmem" or "hbm"; "tiled" for pairwise).  The
    reference chose its ELL layout by the TPU's VMEM budget, which has no
    counterpart; the port's default is `ops.ELL_DEFAULT_LAYOUT`.
  * `chunk`: the ELL direct gather's P, or the staged gather's span in row
    groups (0 for the others).

**What a search times.**  `ops.py` supplies the `runner`, and its candidate
launches run on the request's own tensors, writing into scratch outputs.
The reference timed synthetic inputs of the bucket's shape; on Hopper an
ELL gather whose indices are all 0 hits L1 on every slot and runs at ~24 us
against the real graph's ~53 us (PERF.md), so it would rank the candidates
by a regime the fit never meets.  `runner(cfg, bucket_n)` keeps the
reference's signature; the port's runners ignore `bucket_n`.

**Buckets.**  N rounds up to the next power of two, saturating at a cap a
kernel, so that every N in a bucket shares one search.  The caps are where
a kernel's launch is many waves of the card's 132 SMs deep at every
candidate, so that a larger N only adds waves alike for all of them:
pairwise 16384 (at 16 rows a block, the largest candidate, 1024 blocks;
a search there costs ~9 candidates x 16 launches x 0.64 ms, ~0.1 s in
float32), the ELL and Barnes-Hut kernels 65536 (4096 blocks at 16 rows a
block; a search at k = 229 ~6 x 16 x 70 us, ~7 ms).  Below a cap each
bucket is searched apart, since there the tail wave differs by shape.

**Keys.**  `cache_key` keeps the reference's layout
``{kernel}:n{bucket}:k{k}:d{d}:{dtype}:{device kind}:{mode}``.  The device
kind is `torch.cuda.get_device_name`, filename-safe, so a TPU's entries
never match an H100's; the mode is always ``compiled`` (the port has no
interpret mode).  The staged gather has its own kernel name, ``ell_hbm``,
since its candidates are not the direct gather's; and the kernels whose
work depends on the pair function carry the kind after a dot
(``pairwise.tsne``, ``bh.ee``, ``bh_tree.tsne``), where the reference's
pairwise key has none: on the H100 the pick of the EE problem ran 0.7%
slower than the fixed shape on t-SNE's (PERF.md, PR 22).  A kind shares
its kernel's bucket cap.

**Capture.**  A search never runs while the current stream is being captured
into a CUDA graph: a cache miss there raises and names the fix, one eager
call first.  **Launch counts.**  A search's launches are counted in
`search_launches`, never in the wrappers' `launch_counts` (`count_launch`).
`n_searches` counts the searches of this process (`analysis.guards` pins
it to 0 on a warmed path).

This module imports no kernel wrapper, so the dependency points one way.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Sequence

import torch

# -- configuration record ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One launch shape (module docstring: what each field means on Hopper).
    `block_cols` and `chunk` are 0 when the kernel has no such axis."""

    block_rows: int
    block_cols: int = 0
    layout: str = "vmem"
    chunk: int = 0

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict[str, Any]) -> "KernelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in fields})


# -- cache ---------------------------------------------------------------------

_CACHE: dict[str, KernelConfig] = {}
_DISK_LOADED_FROM: str | None = None

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"

#: searches run by this process (get_config misses)
n_searches = 0
#: per searched key: the candidates' seconds, the pick and the search's
#: wall seconds (for chip_smoke.py and telemetry)
search_log: dict[str, dict] = {}
#: kernel launches made by searches, by kernel name (apart from the
#: wrappers' launch_counts)
search_launches: dict[str, int] = {}

_LOCAL = threading.local()     # .searching: a search runs in this thread


def cache_path() -> str | None:
    return os.environ.get(CACHE_ENV) or None


def clear_cache() -> None:
    """Drop the in-process cache (the disk file, if any, is untouched and
    will be re-read on the next lookup)."""
    global _DISK_LOADED_FROM
    _CACHE.clear()
    _DISK_LOADED_FROM = None


def _load_disk() -> None:
    """Merge the disk cache into the in-process one (in-process wins —
    entries this process already searched or loaded stay put)."""
    global _DISK_LOADED_FROM
    path = cache_path()
    if path is None or _DISK_LOADED_FROM == path:
        return
    _DISK_LOADED_FROM = path
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    for key, obj in payload.get("entries", {}).items():
        _CACHE.setdefault(key, KernelConfig.from_json(obj))


def _save_disk() -> None:
    """Atomically rewrite the disk cache as merge(file, in-process) so
    concurrent processes lose at most their own last search, never the
    file."""
    path = cache_path()
    if path is None:
        return
    entries: dict[str, Any] = {}
    try:
        with open(path) as f:
            entries = json.load(f).get("entries", {})
    except (OSError, json.JSONDecodeError):
        pass
    entries.update({k: v.to_json() for k, v in _CACHE.items()})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".autotune.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"version": 1, "entries": entries}, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


# -- keying --------------------------------------------------------------------

# bucket caps per kernel (module docstring: where a launch is many waves
# deep at every candidate).  Keys saturate with them: every N above the cap
# shares the cap's config.
_BUCKET_CAP = {"pairwise": 16384, "ell": 65536, "ell_hbm": 65536,
               "ell_local": 65536, "bh": 65536, "bh_tree": 65536}


def shape_bucket(kernel: str, n: int) -> int:
    cap = _BUCKET_CAP.get(kernel.split(".")[0], 65536)
    return min(cap, max(8, 1 << max(0, int(n - 1).bit_length())))


@functools.lru_cache(maxsize=None)
def _device_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def device_kind(device: torch.device | None = None) -> str:
    """A stable, filename-safe id of the device a config is tuned for
    (launch shapes do not transfer across GPU models): the CUDA device's
    name, or ``cpu``.  None: the current CUDA device, or ``cpu`` without
    one."""
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        kind = _device_name(index)
    else:
        kind = device.type
    return "".join(c if c.isalnum() else "-" for c in str(kind).lower())


def cache_key(kernel: str, *, n: int, k: int = 0, d: int = 0,
              dtype: str = "float32") -> str:
    b = shape_bucket(kernel, n)
    return f"{kernel}:n{b}:k{k}:d{d}:{dtype}:{device_kind()}:compiled"


# -- candidate generation ------------------------------------------------------

_ROWS_A_WARP_BLOCK = (8, 4, 16)            # pairwise, bh_tree: fixed 8 first
_PAIRWISE_TILES = (1024, 512, 2048)        # fixed 1024 first
_THREADS = (256, 128, 512)                 # ELL direct, bh_rows: fixed first
_STAGED_WARPS = (4, 2, 8)                  # ELL staged: fixed 4 ...
_STAGED_SPANS = (8, 4, 16)                 # ... and 8 first
_P_BUCKETS = (1, 2, 4, 8)


def ell_lanes(k: int) -> int:
    """S, the lanes that sum an ELL row of k slots (csrc/ell.cu): a power
    of two >= k up to a warp, at least 4.  A row's sum order follows S."""
    return 4 if k <= 4 else 8 if k <= 8 else 16 if k <= 16 else 32


def slot_bucket(k: int) -> int:
    """The direct gather's fixed P, a lane's slots a pass: ceil(k / S)
    rounded up to 1, 2, 4 or 8 (wider rows take passes of 8)."""
    return 1 if k <= 32 else 2 if k <= 64 else 4 if k <= 128 else 8


def bh_lanes(width: int) -> int:
    """S, the lanes that sum a Barnes-Hut batch row of `width` slots
    (csrc/farfield.cu): the largest power of two <= width in [4, 32]."""
    return 32 if width >= 32 else 16 if width >= 16 else 8 if width >= 8 else 4


def pairwise_candidates(*, d: int = 2) -> list[KernelConfig]:
    """Rows a block {8, 4, 16} x staged tile {1024, 512, 2048} columns
    (multiples of 256, so legal in both storages); the fixed (8, 1024)
    first.  Above d = 4 the kernel stages no tile: rows only."""
    tiles = _PAIRWISE_TILES if d <= 4 else _PAIRWISE_TILES[:1]
    return [KernelConfig(block_rows=r, block_cols=c, layout="tiled")
            for r in _ROWS_A_WARP_BLOCK for c in tiles]


def ell_candidates(*, k: int, layouts: Sequence[str]) -> list[KernelConfig]:
    """ELL gather candidates for rows of k slots, the fixed shape first.
    "vmem" (and the local-rows kernel): threads a block {256, 128, 512} as
    rows (threads / S) x P in {the bucket k gives, the next one up} where S
    = 32 (at k <= 16 a lane holds one slot, and only P = 1 is built).
    "hbm": warps a block {4, 2, 8} x span {8, 4, 16} row groups."""
    S = ell_lanes(k)
    out: list[KernelConfig] = []
    for layout in layouts:
        if layout == "hbm":
            for warps in _STAGED_WARPS:
                for span in _STAGED_SPANS:
                    out.append(KernelConfig(
                        block_rows=warps * span * (32 // S), layout="hbm",
                        chunk=span))
            continue
        p0 = slot_bucket(k)
        ps = [p0]
        if S == 32 and p0 < _P_BUCKETS[-1]:
            ps.append(2 * p0)
        for threads in _THREADS:
            for p in ps:
                out.append(KernelConfig(block_rows=threads // S,
                                        layout=layout, chunk=p))
    return out


def bh_candidates(*, width: int) -> list[KernelConfig]:
    """The per-batch Barnes-Hut kernel: threads a block {256, 128, 512} as
    rows (threads / S, S the lanes a row of `width` slots); the fixed 256
    threads first."""
    return [KernelConfig(block_rows=t // bh_lanes(width)) for t in _THREADS]


def bh_tree_candidates() -> list[KernelConfig]:
    """The fused tree kernel: rows (a warp each) a block {8, 4, 16}; the
    fixed 8 first."""
    return [KernelConfig(block_rows=r) for r in _ROWS_A_WARP_BLOCK]


# -- search --------------------------------------------------------------------

#: launches a timed rep (enough that the queue stays ahead of the card)
LAUNCHES_A_REP = 5


def count_launch(counts: dict[str, int], name: str) -> None:
    """Count one launch of kernel `name`: in `counts` (a wrapper's
    launch_counts), or in `search_launches` while a search runs in this
    thread."""
    if getattr(_LOCAL, "searching", False):
        search_launches[name] = search_launches.get(name, 0) + 1
    else:
        counts[name] += 1


def _capturing() -> bool:
    return (torch.cuda.is_available() and torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def measure(fn: Callable[[], Any], reps: int = 3) -> float:
    """Seconds a call of `fn`, best of `reps` after one warm-up call; `inf`
    when the candidate fails to run.  With CUDA in use, `fn` launches on
    the current stream and a rep is LAUNCHES_A_REP calls between two CUDA
    events; on the CPU a rep is one call on the wall clock."""
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            fn()                                  # warm-up
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(max(1, reps)):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(LAUNCHES_A_REP):
                    fn()
                stop.record()
                stop.synchronize()
                best = min(best, start.elapsed_time(stop) / LAUNCHES_A_REP
                           * 1e-3)
            return best
        fn()
        best = float("inf")
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    except Exception:
        return float("inf")


def get_config(
    kernel: str,
    *,
    n: int,
    k: int = 0,
    d: int = 0,
    dtype: str = "float32",
    candidates: Sequence[KernelConfig],
    runner: Callable[[KernelConfig, int], Callable[[], Any]],
    reps: int = 3,
) -> tuple[KernelConfig, bool]:
    """The autotuned config for this request: cache hit or search.

    `runner(cfg, bucket_n)` returns a zero-argument callable launching the
    kernel once under `cfg` on the request's tensors (ops.py owns the
    launch).  Returns ``(config, from_cache)``; the search result is stored
    in-process and mirrored to the `REPRO_AUTOTUNE_CACHE` file when set.
    With every candidate scoring `inf` the first candidate (the fixed
    shape) is returned — and cached, so the failure is paid once.  A miss
    while the current stream is captured into a CUDA graph raises."""
    global n_searches
    if not candidates:
        raise ValueError(f"no candidates for kernel {kernel!r}")
    key = cache_key(kernel, n=n, k=k, d=d, dtype=dtype)
    _load_disk()
    hit = _CACHE.get(key)
    if hit is not None:
        return hit, True
    if _capturing():
        raise RuntimeError(
            f"autotune: no launch shape cached for {key} and the current "
            f"stream is being captured into a CUDA graph, where a search "
            f"cannot run; make one eager call with the same shapes first")

    bucket = shape_bucket(kernel, n)
    t0 = time.perf_counter()
    timings: list[tuple[float, int]] = []
    _LOCAL.searching = True
    try:
        for i, cfg in enumerate(candidates):
            timings.append((measure(runner(cfg, bucket), reps=reps), i))
    finally:
        _LOCAL.searching = False
    best_t, best_i = min(timings)
    best = candidates[0] if best_t == float("inf") else candidates[best_i]
    n_searches += 1
    search_log[key] = {
        "timings": [(candidates[i].to_json(), t) for t, i in timings],
        "pick": best.to_json(), "seconds": time.perf_counter() - t0}
    _CACHE[key] = best
    _save_disk()
    return best, False


def cached_entries() -> dict[str, KernelConfig]:
    """Snapshot of the in-process cache (for telemetry / the bench)."""
    _load_disk()
    return dict(_CACHE)
