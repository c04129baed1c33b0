"""Where the dense lineup's kernel path can be held against its plain path,
on one GPU.

    python3 lineup_witness.py [--out FILE]

On the EE problem of `chip_smoke.py`'s phase fit (`mnist_like(n=20000,
dim=784)`, perplexity 30), from three starts: the spectral start, and the
embedding after ten and after thirty SD iterations at lambda = 100 (kappa =
7).  From each, at lambda = 100, 10 and 1, it runs GD, DiagH, nonlinear CG,
L-BFGS and SD- for five iterations three ways: the kernel path, the plain
path (`kernel_impl="torch"`) and the plain path in float64
(`chip_smoke._plain64_energies`).  Then the same on t-SNE (lambda = 1) from
its spectral start.  For every run it prints each pair's relative energy
gap after each iteration and the method's gap to GD's kernel-path trace;
for each start and lambda, how many entries of DiagH's Hessian diagonal lie
above its floor and how many within 1e-4 of its largest magnitude of zero,
and the kernel's and the plain path's gradient off the float64 one, as a
share of its largest magnitude.  Then the card's name and power limit, and
the numbers as JSON to `--out`.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

METHODS = ("gd", "diag", "cg", "lbfgs", "sd-")


def gaps(a, b) -> list[float]:
    """The relative gap of trace a to trace b after each iteration."""
    n = min(len(a), len(b))
    a, b = np.asarray(a[:n]), np.asarray(b[:n])
    return (np.abs(a - b) / np.abs(b)).tolist()


def gradient_errors(X, aff, kind: str, lam: float) -> tuple[float, float]:
    """The kernel's and the plain path's gradient at X off the float64
    plain gradient, each over the float64 gradient's largest magnitude."""
    from repro_torch.core.affinities import Affinities
    from repro_torch.core.objectives import energy_and_grad
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import pairwise_terms_ref

    lam_t = torch.tensor(lam, device=X.device)
    G_kernel = energy_and_grad(X, aff, kind, lam_t)[1].double()
    G_plain = energy_and_grad(X, aff, kind, lam_t, impl="torch")[1].double()
    with mock.patch.object(ops, "pairwise_terms",
                           lambda X, Wa, Wb, kind, **_: pairwise_terms_ref(
                               X, Wa, Wb, kind)):
        G64 = energy_and_grad(X.double(), Affinities(aff.Wp.double(),
                                                     aff.Wm.double()),
                              kind, lam_t.double(), impl="torch")[1]
    scale = G64.abs().max()
    return (float((G_kernel - G64).abs().max() / scale),
            float((G_plain - G64).abs().max() / scale))


def diag_zone(X, aff, kind: str, lam: float) -> tuple[int, int, int]:
    """DiagH's diagonal at X: entries above the floor, entries within 1e-4
    of its largest magnitude of zero, and all entries."""
    from repro_torch.core.hessians import diag_hessian
    above, total = cs._diag_above_floor(X, aff, kind, lam)
    d = diag_hessian(X, aff, kind, torch.tensor(lam, device=X.device))
    near = int((d.abs() < 1e-4 * d.abs().max()).sum())
    return above, near, total


def witness(kind: str, start: str, X, aff, lam: float) -> dict:
    from repro_torch.api import Embedding, EmbedSpec
    out = {"kind": kind, "start": start, "lam": lam}
    out["grad_err_kernel"], out["grad_err_plain"] = gradient_errors(
        X, aff, kind, lam)
    out["diag_above"], out["diag_near_zero"], out["entries"] = diag_zone(
        X, aff, kind, lam)
    print(f"{kind} from {start} at lambda={lam:g}: gradient off float64 "
          f"kernel {out['grad_err_kernel']:.2e}, plain "
          f"{out['grad_err_plain']:.2e} (of max |G|); DiagH's diagonal: "
          f"{out['diag_above']} of {out['entries']} above the floor, "
          f"{out['diag_near_zero']} within 1e-4 of zero", flush=True)
    gd = None
    for method in METHODS:
        spec = EmbedSpec(kind=kind, lam=lam, perplexity=30.0,
                         backend="dense", strategy=method, max_iters=5,
                         tol=0.0)
        t0 = time.perf_counter()
        k = Embedding(spec).fit(None, X0=X, aff=aff).result_.energies
        p = cs._plain_energies(spec, X, aff, 5)
        w = cs._plain64_energies(spec, X, aff, 5)
        gd = k if method == "gd" else gd
        row = {"kernel_vs_plain": gaps(k, p), "plain_vs_float64": gaps(p, w),
               "kernel_vs_float64": gaps(k, w), "vs_gd": gaps(k, gd)}
        out[method] = row
        fmt = {name: np.array2string(np.asarray(v), precision=2)
               for name, v in row.items()}
        print(f"  {method:5s} kernel-plain {fmt['kernel_vs_plain']} "
              f"plain-float64 {fmt['plain_vs_float64']} kernel-float64 "
              f"{fmt['kernel_vs_float64']} to GD {fmt['vs_gd']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    from repro_torch.api import Embedding, EmbedSpec
    from repro_torch.data import mnist_like

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    Y, _ = mnist_like(n=cs.N_FIT, dim=784, seed=0)
    rows = []
    ee = EmbedSpec(kind="ee", lam=100.0, perplexity=30.0, backend="dense",
                   strategy="sd", strategy_opts={"kappa": 7}, max_iters=10,
                   tol=0.0)
    emb = Embedding(ee).fit(Y)
    aff = emb.affinities_
    starts = {"the spectral start": emb.X0_,
              "ten SD iterations": emb.embedding_,
              "thirty SD iterations": Embedding(ee.replace(max_iters=30)).fit(
                  None, X0=emb.X0_, aff=aff).embedding_}
    del emb
    for start, X in starts.items():
        for lam in (100.0, 10.0, 1.0):
            rows.append(witness("ee", start, X, aff, lam))
    del starts, aff
    torch.cuda.empty_cache()
    tsne = Embedding(EmbedSpec(kind="tsne", lam=1.0, perplexity=30.0,
                               backend="dense", strategy="sd",
                               max_iters=0, tol=0.0)).fit(Y)
    rows.append(witness("tsne", "the spectral start", tsne.X0_,
                        tsne.affinities_, 1.0))
    card = cs.smi()
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
