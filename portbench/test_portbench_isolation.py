"""The benchmark imports neither JAX nor the JAX package, and its reference
imports nothing of the program.

Top-level names are compared whole: the port's package name
(``reluqp_tpu_torch``) begins with the JAX package's (``reluqp_tpu``).
"""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "reluqp_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not {n for n in _top_level_imports(path)
                if n.startswith("reluqp_tpu")}


def test_walk_found_the_harness():
    names = {str(p.relative_to(HERE)) for p in SOURCES}
    assert {"run.py", "mixes.py", "control.py", "reference/judge.py",
            "reference/qp.py", "kinds/__init__.py"} <= names
