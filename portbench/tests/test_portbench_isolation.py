"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast

import pytest

from portbench import harness

ROOT = harness.ROOT / "portbench"
MODULES = sorted(p for p in ROOT.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "gparml_tpu"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in MODULES if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "gparml_tpu_torch" not in names
    assert names <= {"__future__", "math", "typing", "torch", "portbench"}


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's: compared whole, it passes
    assert "gparml_tpu_torch" not in FORBIDDEN
    assert "gparml_tpu_torch.models".split(".")[0] not in FORBIDDEN


def test_a_run_checks_the_loaded_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert harness.forbidden_modules() == ["jaxlib"]
