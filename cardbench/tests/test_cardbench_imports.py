"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: ``repro_torch`` is the port, ``repro`` the JAX package."""
import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Every top-level module name ``path`` imports (relative imports are
    the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "repro_torch" not in imported(path)


def test_check_is_whole_names():
    import run

    assert "repro_torch" not in run.FORBIDDEN and "repro" in run.FORBIDDEN
