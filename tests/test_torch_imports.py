"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
import os
from pathlib import Path

import pytest

ROOT = Path(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").is_file()
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports():
    for src in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.core import graph", "import repro.compress"):
        assert set(_imported_roots(ast.parse(src))) & set(FORBIDDEN), src
    for src in ("import repro_torch", "from repro_torch.core import graph",
                "from . import ref", "from ..core.graph import Graph"):
        assert not set(_imported_roots(ast.parse(src))) & set(FORBIDDEN), src
