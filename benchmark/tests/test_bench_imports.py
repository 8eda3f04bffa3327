"""No module of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program: top-level module names compared
whole (``monkey_moore_tpu_torch`` begins with ``monkey_moore_tpu``)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "monkey_moore_tpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "traffic.py", "stats.py"):
        imports = top_level_imports(HERE / name)
        assert imports <= {"__future__", "bisect", "math",
                           "collections", "dataclasses", "typing", "sys",
                           "pathlib", "numpy", "torch"}, (name, imports)


def test_the_check_compares_names_whole():
    assert "monkey_moore_tpu_torch" not in FORBIDDEN
    assert "monkey_moore_tpu_torch".split(".")[0] != "monkey_moore_tpu"
