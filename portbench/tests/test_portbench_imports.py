"""No module the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared whole)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "plotweave"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


MODULES = sorted(p for p in PORTBENCH.rglob("*.py") if "tests" not in p.relative_to(PORTBENCH).parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PORTBENCH)))
def test_portbench_imports_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((PORTBENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_portbench_reference_imports_no_program(path):
    assert "plotweave_torch" not in top_level_imports(path)


def test_portbench_scan_sees_the_names_whole():
    assert {"plotweave_torch"} & BANNED == set()
    assert top_level_imports(PORTBENCH / "entries" / "frontend.py") >= {"portbench", "torch", "numpy"}
