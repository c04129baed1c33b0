"""The port (src/repro_torch) imports neither JAX nor the JAX package.

Checked twice: statically, over every import statement of every module and
of `chip_smoke.py` (the port's GPU smoke run), `ell_ab.py` (its A/B
timing of ELL kernel sources) and `lineup_witness.py` (where the dense
lineup's kernel path can be held against its plain path), and at run time, by importing
every module in a fresh interpreter and looking at `sys.modules`.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__"):
            yield node.lineno, "__import__"
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module"):
            yield node.lineno, "import_module"


@pytest.mark.parametrize("path", [*sorted(PORT.rglob("*.py")),
                                  ROOT / "chip_smoke.py", ROOT / "ell_ab.py",
                                  ROOT / "lineup_witness.py"],
                         ids=lambda p: str(p.relative_to(PORT))
                         if p.is_relative_to(PORT) else p.name)
def test_module_imports_no_jax_and_no_repro(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN or root in ("__import__", "import_module")]
    assert bad == [], f"{path}: {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
