"""Versioned fitted-embedding artifacts: `fit` once, serve anywhere.

Port of `repro/api/artifact.py`, schema v1, byte-compatible with the
reference: the port loads what `repro` writes and `repro` loads what the
port writes.  An artifact is one `.npz` file holding everything
`Embedding.transform` needs: the fitted training embedding, the training
data (snapshot or reference), the frozen `EmbedSpec` and calibration and
graph statistics.  `Embedding.save()` / `Embedding.load()` are the public
wrappers; `repro_torch.serve` serves from artifacts.

Layout (numpy savez):

  * ``__header__``  UTF-8 JSON bytes (uint8 array), the header below;
  * ``X``           the (N, dim) fitted embedding, written from the device
                    as float32;
  * ``Y``           the (N, D) training data, only in ``train="snapshot"``
                    mode.

Header schema (version 1)::

    {"format": "repro-embedding-artifact", "schema_version": 1,
     "created_unix": float,
     "spec": {...EmbedSpec fields; "ls" is an LSConfig dict or null...},
     "train": {"storage": "snapshot"|"ref", "ref": str|null,
               "sha256": str, "shape": [N, D], "dtype": str},
     "graph": {"k": int, "perplexity": float, "knn_method": str,
               "y_norm_mean": float, "y_norm_max": float},
     "stats": {"backend": str|null, "final_energy": float|null,
               "n_iters": int|null, "converged": bool|null}}

Compatibility rules (the reference's; the golden fixture in tests/data/
pins them):

  * readers IGNORE unknown header keys, unknown npz members and unknown
    `spec` fields (the schema is append-only; a knob this library does not
    know falls back to its default);
  * a ``schema_version`` greater than `SCHEMA_VERSION` is refused;
  * ``train="ref"`` stores only the training data's path and SHA-256: `load`
    re-reads the referenced ``.npy`` (or takes ``Y_train=``) and verifies
    the hash, so a stale reference fails loudly.

The two packages' `EmbedSpec`s differ only in the words of `kernel_impl`:
it is written in the reference's (kernel -> pallas, torch -> jnp,
`convert.KERNEL_IMPL_TO_JAX`) and read back through `convert.KERNEL_IMPL`
(pallas -> kernel, jnp and pallas-interpret -> torch).  Every other field,
`checkpoint_dir` and `checkpoint_every` included, is written and read as
it is, as the reference's loader keeps it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.linesearch import LSConfig

from .spec import EmbedSpec

FORMAT = "repro-embedding-artifact"
SCHEMA_VERSION = 1

HEADER_KEY = "__header__"


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _spec_to_json(spec: EmbedSpec) -> dict:
    d = dataclasses.asdict(spec)          # ls becomes a keyed dict
    d["strategy_opts"] = dict(spec.strategy_opts)
    d["kernel_impl"] = convert.KERNEL_IMPL_TO_JAX[spec.kernel_impl]
    return d


def _spec_from_json(obj: dict) -> EmbedSpec:
    known = ({f.name for f in dataclasses.fields(EmbedSpec)}
             | convert.UNPORTED_FIELDS)
    fields = {k: v for k, v in obj.items() if k in known}
    ls = fields.get("ls")
    if ls is not None:
        known_ls = {f.name for f in dataclasses.fields(LSConfig)}
        fields["ls"] = {k: v for k, v in ls.items() if k in known_ls}
    return convert.spec_from_jax_fields(fields)


def save_artifact(est, path: str, *, train: str = "snapshot",
                  train_ref: str | None = None) -> str:
    """Write a fitted `Embedding` to `path` (an `.npz` artifact).

    `train="snapshot"` embeds Y in the file (self-contained, the default);
    `train="ref"` stores only `train_ref` (a path to an ``.npy``) plus the
    SHA-256 of Y.  Returns `path`."""
    X = getattr(est, "embedding_", None)
    if X is None:
        raise ValueError("save() requires a fitted estimator")
    Y = getattr(est, "_Y_train", None)
    if Y is None:
        raise ValueError(
            "save() needs the raw training Y; this estimator was fit from "
            "precomputed affinities only")
    if train not in ("snapshot", "ref"):
        raise ValueError(f"unknown train storage {train!r}; "
                         f"have 'snapshot' | 'ref'")
    if train == "ref" and not train_ref:
        raise ValueError("train='ref' needs train_ref (a path to the "
                         "training Y as .npy)")
    X = _host(X).astype(np.float32, copy=False)
    Y = _host(Y)
    spec = est.spec
    res = getattr(est, "result_", None)
    k = spec.n_neighbors or int(3 * spec.perplexity)
    norms = np.sqrt(np.sum(Y.astype(np.float64) ** 2, axis=1))
    header = {
        "format": FORMAT,
        "schema_version": SCHEMA_VERSION,
        "created_unix": time.time(),
        "spec": _spec_to_json(spec),
        "train": {
            "storage": train,
            "ref": train_ref,
            "sha256": _sha256(Y),
            "shape": list(Y.shape),
            "dtype": str(Y.dtype),
        },
        "graph": {
            "k": int(min(k, Y.shape[0])),
            "perplexity": float(spec.perplexity),
            "knn_method": spec.knn_method,
            "y_norm_mean": float(norms.mean()) if len(norms) else 0.0,
            "y_norm_max": float(norms.max()) if len(norms) else 0.0,
        },
        "stats": {
            "backend": getattr(est, "backend_", None),
            "final_energy": (float(res.energies[-1])
                             if res is not None and len(res.energies)
                             else None),
            "n_iters": int(res.n_iters) if res is not None else None,
            "converged": bool(res.converged) if res is not None else None,
        },
    }
    arrays = {"X": X}
    if train == "snapshot":
        arrays["Y"] = Y
    write_artifact(path, header, arrays)
    return path


def write_artifact(path: str, header: dict, arrays: dict) -> None:
    """Low-level writer (exposed for schema tests): header dict plus named
    arrays into one `.npz`, written to a temporary file and renamed."""
    hb = np.frombuffer(json.dumps(header).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **{HEADER_KEY: hb}, **arrays)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def read_header(path: str) -> dict:
    """The artifact's header dict, validated for format and schema version
    (the forward-compatibility gate) but nothing else."""
    with np.load(path) as z:
        if HEADER_KEY not in z:
            raise ValueError(
                f"{path} is not a repro embedding artifact (missing "
                f"{HEADER_KEY})")
        header = json.loads(bytes(z[HEADER_KEY].tobytes()).decode("utf-8"))
    if header.get("format") != FORMAT:
        raise ValueError(f"{path} has format {header.get('format')!r}, "
                         f"expected {FORMAT!r}")
    ver = int(header.get("schema_version", 0))
    if ver > SCHEMA_VERSION:
        raise ValueError(
            f"{path} uses artifact schema v{ver}, newer than this library's "
            f"v{SCHEMA_VERSION}; upgrade repro_torch to load it (older "
            f"schemas load forever, newer ones never silently)")
    if ver < 1:
        raise ValueError(f"{path} has invalid schema_version {ver!r}")
    return header


def load_artifact(path: str, *, Y_train=None, device=None):
    """Reload a fitted `Embedding` from an artifact onto `device` (None:
    CUDA, which must be available): no refit, no original process needed.

    `Y_train` overrides the stored training data (needed for ``train="ref"``
    artifacts whose reference is not readable); it is verified against the
    stored SHA-256.  Returns the estimator with `embedding_` / `spec` /
    `backend_` restored and `loaded_from_` / `artifact_header_` set."""
    from .estimator import Embedding  # late: artifact <-> estimator cycle

    header = read_header(path)
    with np.load(path) as z:
        X = np.array(z["X"])
        Y = np.array(z["Y"]) if "Y" in z else None

    train = header.get("train", {})
    if Y_train is not None:
        Y = _host(Y_train)
    elif Y is None:
        ref = train.get("ref")
        if ref and os.path.exists(ref):
            Y = np.load(ref)
        # else: loadable without Y; transform() says what is missing
    if Y is not None and train.get("sha256"):
        got = _sha256(Y)
        if got != train["sha256"]:
            raise ValueError(
                f"training-data hash mismatch for {path}: artifact expects "
                f"sha256={train['sha256'][:12]}..., got {got[:12]}... - the "
                f"referenced Y drifted since save()")

    est = Embedding(_spec_from_json(header.get("spec", {})), device=device)
    est.embedding_ = torch.as_tensor(X, dtype=torch.float32,
                                     device=est.device)
    est._Y_train = Y
    est.backend_ = (header.get("stats") or {}).get("backend")
    est.result_ = None
    est.loaded_from_ = path
    est.artifact_header_ = header
    return est
