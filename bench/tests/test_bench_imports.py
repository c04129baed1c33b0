"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (`repro_torch` begins with `repro`), and the
reference, the counts, the metric readers and the data generators import
nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
INDEPENDENT = ("reference", "counts", "metrics", "data")
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.relative_to(BENCH).parts[0] in INDEPENDENT],
    ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_name_comparison():
    from harness import env
    import sys
    sys.modules["repro.fake_for_test"] = sys
    try:
        assert "repro.fake_for_test" in env.forbidden_modules_loaded()
    finally:
        del sys.modules["repro.fake_for_test"]
    assert not any(n.split(".")[0] == "repro_torch"
                   for n in env.forbidden_modules_loaded())
