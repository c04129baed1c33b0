"""The port's public names against the reference's (ROADMAP, Queue 3, F1).

The port mirrors `repro` module for module with the same public names.
Compared here: each ported package's `__all__`, and the names that each
ported module defines at its top level (functions, classes and
constants, not the `Array = jnp.ndarray` type aliases of JAX's array type).
A name the port lacks must be on `ALLOWED`, which holds ROADMAP's "Not
ported" names and those of the items still to port (26b, the LM training
half; 26c, the production mesh's helpers), and nothing else; each of them
must still be missing.
The five Pallas wrappers are ported under their Hopper names (`HOPPER`).

The three functions F1 found missing are held against JAX here, at the
tolerances of tests/test_affinities.py, tests/test_laplacian.py and
tests/test_torch_core.py.
"""
import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.affinities import sne_affinities as jsne_affinities
from repro.core.affinities import sne_affinities_from_d2 as jsne_from_d2
from repro.core.affinities import sq_distances as jsq_distances
from repro.core.laplacian import laplacian as jlaplacian
from repro_torch.core import sne_affinities, sne_affinities_from_d2
from repro_torch.core.affinities import sq_distances
from repro_torch.core.laplacian import laplacian, laplacian_matmul
from tests.conftest import three_loops

SRC = Path(__file__).resolve().parents[1] / "src"
#: the reference's packages that have an `__all__` (`repro` and
#: `repro.launch` have none; launch/mesh.py's names are compared below)
PACKAGES = (".analysis", ".api", ".ckpt", ".configs", ".core", ".data",
            ".embed", ".kernels", ".models", ".obs", ".serve", ".sparse")
#: ROADMAP "Not ported": the deprecation shims (`core.minimize.minimize`;
#: `EmbedConfig`, `DistributedEmbedding`, `FitResult` and `to_fit_result` of
#: embed/trainer.py; `UNSET`, the legacy transform kwargs' sentinel), the
#: TPU tiling helpers of kernels/ops.py and the JAX shims of
#: launch/mesh.py (`axis_size` reads an axis inside a shard_map body), and
#: the JAX guards of analysis/guards.py that have no torch meaning
#: (`jit_cache_size` reads a jit's trace cache, `no_tracer_leaks` wraps
#: jax.checking_leaks: PyTorch runs eagerly, with no jit and no tracer)
NOT_PORTED = {"minimize", "EmbedConfig", "DistributedEmbedding", "FitResult",
              "to_fit_result", "UNSET", "sublane", "legal_tile",
              "vmem_x_budget", "VMEM_X_BUDGET_ENV", "shard_map_norep",
              "axis_types_kwargs", "make_abstract_mesh", "axis_size",
              "jit_cache_size", "no_tracer_leaks"}
#: ROADMAP item 26b (the training half of models/train.py) and 26c
#: (launch/mesh.py's production-mesh helpers)
ITEM_26B = {"init_train_state", "make_train_step", "params_specs",
            "train_state_specs"}
ITEM_26C = {"make_production_mesh", "n_chips"}
ALLOWED = NOT_PORTED | ITEM_26B | ITEM_26C
#: the Pallas wrappers and the Hopper wrappers that replace them
HOPPER = {"pairwise_terms_pallas": "pairwise_terms_cuda",
          "ell_lap_matvec_pallas": "ell_lap_matvec_cuda",
          "ell_lap_matvec_pallas_hbm": "ell_lap_matvec_cuda",
          "ell_lap_matvec_local_pallas": "ell_lap_matvec_local_cuda",
          "bh_interaction_pallas": "bh_interaction_cuda"}


def _defined_names(path: Path) -> set[str]:
    """The public names a module defines at its top level."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if (isinstance(value, ast.Attribute)
                    and isinstance(value.value, ast.Name)
                    and value.value.id in ("jax", "jnp")):
                continue            # a type alias of JAX's array type
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _ported_modules():
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        rel = path.relative_to(SRC / "repro_torch")
        if (SRC / "repro" / rel).exists() and path.name != "__init__.py":
            yield str(rel.with_suffix("")).replace("/", ".")


@pytest.mark.parametrize("package", PACKAGES)
def test_package_all_matches_the_reference(package):
    ref = set(importlib.import_module("repro" + package).__all__)
    port = importlib.import_module("repro_torch" + package)
    missing = ref - set(port.__all__)
    assert missing <= ALLOWED, sorted(missing - ALLOWED)
    for name in ref - missing:
        assert hasattr(port, name), name


@pytest.mark.parametrize("module", list(_ported_modules()))
def test_module_names_match_the_reference(module):
    ref = _defined_names(SRC / "repro" / (module.replace(".", "/") + ".py"))
    port = importlib.import_module("repro_torch." + module)
    missing = {n for n in ref if not hasattr(port, n)}
    for name in missing & set(HOPPER):
        assert hasattr(port, HOPPER[name]), (name, HOPPER[name])
    missing -= set(HOPPER)
    assert missing <= ALLOWED, sorted(missing - ALLOWED)


def test_allowed_names_are_all_still_missing():
    """Every allowed name is a public name of the reference that the port
    lacks: the list cannot hide a name that has been ported."""
    ref, port = set(), set()
    for package in PACKAGES:
        ref |= set(importlib.import_module("repro" + package).__all__)
        port |= set(importlib.import_module("repro_torch" + package).__all__)
    for module in _ported_modules():
        path = SRC / "repro" / (module.replace(".", "/") + ".py")
        ref |= _defined_names(path)
        port |= {n for n in _defined_names(path) if hasattr(
            importlib.import_module("repro_torch." + module), n)}
    assert ALLOWED <= ref - port, sorted(ALLOWED - (ref - port))


# -- the functions F1 found missing ----------------------------------------------


@pytest.fixture(scope="module")
def Y():
    return np.asarray(three_loops(n_per=16, loops=2, dim=8), np.float32)


@pytest.mark.parametrize("perplexity", [5.0, 8.0])
def test_sne_affinities_match_jax(Y, perplexity):
    """The joint P against JAX's at rtol 1e-4 with an absolute part of 1e-5
    max|P| (tests/test_torch_core.py's bound for the affinities); like
    JAX's it sums to one (atol 1e-5) and is symmetric (atol 1e-7),
    tests/test_affinities.py."""
    want = np.asarray(jsne_affinities(jnp.asarray(Y), perplexity))
    P = sne_affinities(torch.tensor(Y), perplexity)
    np.testing.assert_allclose(P.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert abs(float(P.sum()) - 1.0) <= 1e-5
    np.testing.assert_allclose(P.numpy(), P.T.numpy(), atol=1e-7)
    assert bool((P >= 0).all())


def test_sne_affinities_from_d2_match_jax(Y):
    """From JAX's squared distances: JAX's joint P, and the port's P from
    its own distances."""
    D2 = np.asarray(jsq_distances(jnp.asarray(Y)))
    want = np.asarray(jsne_from_d2(jnp.asarray(D2), 8.0))
    got = sne_affinities_from_d2(torch.tensor(D2), 8.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    own = sne_affinities(torch.tensor(Y), 8.0)
    assert torch.equal(sne_affinities_from_d2(sq_distances(torch.tensor(Y)),
                                              8.0), own)


@pytest.mark.parametrize("n", [3, 16, 24])
def test_laplacian_matches_jax(n):
    """L = D - W against JAX's at rtol 1e-5 / atol 1e-5
    (tests/test_laplacian.py), with zero row sums and L X =
    laplacian_matmul(W, X)."""
    W = jnp.abs(jax.random.normal(jax.random.PRNGKey(n), (n, n)))
    W = 0.5 * (W + W.T) * (1.0 - jnp.eye(n))
    want = np.asarray(jlaplacian(W))
    L = laplacian(torch.tensor(np.asarray(W)))
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.sum(1).numpy(), 0.0, atol=1e-4)
    X = torch.tensor(np.random.default_rng(n).normal(size=(n, 2)),
                     dtype=torch.float32)
    np.testing.assert_allclose(
        (L @ X).numpy(),
        laplacian_matmul(torch.tensor(np.asarray(W)), X).numpy(),
        rtol=1e-5, atol=1e-5)
