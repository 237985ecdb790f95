"""The benchmark's import rules, read from its sources."""
import ast
import sys
from pathlib import Path

import pytest

from phibench import harness

HERE = Path(__file__).resolve().parent
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
JAX_BENCHES = "bench" + "marks"          # the JAX package's benchmark folder


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmarks(path):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if JAX_BENCHES + "/" in s or s == JAX_BENCHES]


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.core", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    found = harness.forbidden_modules()
    assert "repro.core" in found
    assert "repro_torch_lookalike" not in found and "jaxlike.core" not in found
