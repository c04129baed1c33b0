"""Lazy build and load of the hand-written CUDA kernels.

Every `csrc/*.cu` compiles with `nvcc` into its own shared library with a
plain C interface, loaded through `ctypes`.  Nothing is built when the
package is imported: the first `load(name)` builds every source at once,
one `nvcc` process per source, started together, and caches the loaded
libraries for the life of the process.

Libraries go to `build/repro_torch_kernels/` at the root of the checkout
(`build/` is git-ignored), named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused; the compiler's
output (with ptxas's register and spill report) is kept beside each
library as `<name>-<hash>.log`.  A failed build
raises with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: `_build_all` runs in this process (`analysis.guards` pins it to 0 on a
#: warmed path)
n_builds = 0
#: per source: {"seconds": build wall time (0.0 when reused), "log": ptxas
#: and compiler output, "path": the library}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else
    /usr/local/cuda/bin/nvcc.  Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of repro_torch are built from source at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build_all() -> None:
    """Compile every source whose library is missing, all in parallel."""
    global n_builds
    n_builds += 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = []
    for src in _sources():
        out = BUILD_DIR / f"{src.stem}-{_digest(src)}.so"
        if out.is_file():
            log = out.with_suffix(".log")
            BUILD_INFO[src.stem] = {
                "seconds": 0.0, "path": str(out),
                "log": log.read_text() if log.is_file() else ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending.append((src, out, tmp, proc, time.perf_counter()))
    failures = []
    for src, out, tmp, proc, t0 in pending:
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        BUILD_INFO[src.stem] = {"seconds": secs, "log": log, "path": str(out)}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (building every
    kernel source on first use)."""
    with _LOCK:
        if name not in _LIBS:
            if name not in BUILD_INFO:
                _build_all()
            if name not in BUILD_INFO:
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            _LIBS[name] = ctypes.CDLL(BUILD_INFO[name]["path"])
        return _LIBS[name]
