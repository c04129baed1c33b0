"""A/B timing of ELL kernel sources on one GPU.

    python3 ell_ab.py [NAME=PATH.cu ...] [--out FILE]

Builds each given source of the ELL library (an earlier or patched copy of
`src/repro_torch/kernels/csrc/ell.cu` with the same C entry point, whose
launch shape it leaves at 0, the fixed shape; one nvcc
each, all started together, into the git-ignored `build/ell_ab/`, with
nvcc's log beside each library), beside
the checkout's own `ell.cu` (named `checkout`).  On the sparse fits' graphs
at N = 70000 (`mnist_like(n=70000, dim=784)`, k = 90 by kNN at perplexity
30; the forward graph and its reverse) with a random X of width 2 from a
seed, float32 and bfloat16 storage, it times every library's staged ("hbm")
and direct ("vmem") layouts by CUDA-graph replay (`chip_smoke.graph_ms`), in
turns: every library, then again in reverse order.  Each output is held
against the checkout's direct gather bit for bit.  Prints one line a
library, graph and storage, then the card's name and power limit, and
writes the numbers as JSON to `--out`.  Exits 1 if the checkout's own
layouts differ in a bit; another library's difference is printed only.
Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import graph_ms, smi  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sparse_attractive import STORAGE  # noqa: E402

OUT_DIR = ROOT / "build" / "ell_ab"
LAYOUTS = ("vmem", "hbm")     # the C entry point's layout codes 0 and 1


def build(sources: dict[str, Path]) -> dict[str, ctypes.CDLL]:
    """{name: library}, every nvcc started at once."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = OUT_DIR / f"ell-{name}.so"
        cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out.with_suffix(".log").write_text(log)
        lib = ctypes.CDLL(str(out))
        fn = lib.ell_lap_matvec_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, X, idx, w, layout: str) -> torch.Tensor:
    n, d = X.shape
    out = torch.empty((n, d), dtype=torch.float32, device=X.device)
    status = lib.ell_lap_matvec_launch(
        X.data_ptr(), idx.data_ptr(), w.data_ptr(), n, d, idx.shape[1],
        STORAGE[X.dtype], LAYOUTS.index(layout), 0, 0, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"{layout} launch failed: CUDA error {status}")
    return out


def graphs(n: int = 70000, seed: int = 0) -> dict:
    from repro_torch.data import mnist_like
    from repro_torch.sparse.graph import sparse_affinities
    Y, _ = mnist_like(n=n, dim=784, seed=seed)
    saff = sparse_affinities(torch.from_numpy(Y).cuda(), k=90,
                             perplexity=30.0, model="ee")
    return {"forward": saff.graph, "reverse": saff.rev}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH.cu")
    ap.add_argument("--out", help="write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ell_ab: CUDA is not available", file=sys.stderr)
        return 1
    sources = {"checkout": _build.CSRC / "ell.cu"}
    for item in args.sources:
        name, _, path = item.partition("=")
        sources[name] = Path(path)
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(1)
    X32 = torch.randn((70000, 2), generator=gen, device="cuda")
    names = list(libs)
    results, bad = [], []
    for gname, g in graphs().items():
        rows = torch.arange(g.n, device=g.indices.device, dtype=torch.int32)
        live = int((g.indices != rows[:, None]).sum())
        for storage, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            X = X32.to(dt).contiguous()
            w = g.weights.to(dt).contiguous()
            idx = g.indices
            want = launch(libs["checkout"], X, idx, w, "vmem")
            times = {(name, lay): [] for name in names for lay in LAYOUTS}
            for order in (names, names[::-1]):
                for name in order:
                    for lay in LAYOUTS:
                        times[name, lay].append(graph_ms(
                            lambda: launch(libs[name], X, idx, w, lay)))
            for name in names:
                same = {lay: torch.equal(launch(libs[name], X, idx, w, lay),
                                         want) for lay in LAYOUTS}
                if name == "checkout" and not all(same.values()):
                    bad.append((gname, storage))
                row = {"graph": gname, "k": g.k, "live": live,
                       "storage": storage, "source": name,
                       **{f"{lay}_ms": times[name, lay] for lay in LAYOUTS},
                       **{f"{lay}_equals_checkout_vmem": same[lay]
                          for lay in LAYOUTS}}
                results.append(row)
                us = {lay: " / ".join(f"{t * 1e3:.1f}"
                                      for t in times[name, lay])
                      for lay in LAYOUTS}
                print(f"{gname} k={g.k} live={live} {storage} {name}: hbm "
                      f"{us['hbm']} us, vmem {us['vmem']} us (two turns); "
                      f"bits equal to the checkout's vmem: hbm "
                      f"{same['hbm']}, vmem {same['vmem']}")
    device = smi()
    print(device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"device": device,
                                              "results": results}, indent=1))
    if bad:
        print(f"the checkout's layouts differ in a bit on {bad}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
