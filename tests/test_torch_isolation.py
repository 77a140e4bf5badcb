"""The PyTorch port stands apart from JAX: importing any of its modules
or of its examples (examples/torch/) loads neither jax nor the JAX
package, its kernel wrappers and entry points hold no fallback, and
chip_smoke.py fails (printing no result) without a GPU or without the
package beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gparml_tpu_torch"


def _run(args, cwd, **env):
    full = {**os.environ, **env}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=full,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib, gparml_tpu_torch as g\n"
        "for m in pkgutil.walk_packages(g.__path__, 'gparml_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gparml_tpu' or m.startswith('gparml_tpu.')]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_port_sources_never_name_jax():
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "gparml_tpu"), (path, name)


@pytest.mark.parametrize("module", ["gparml_tpu_torch.cli", "gparml_tpu_torch.checkpoint",
                                    "gparml_tpu_torch.utils.logging",
                                    "gparml_tpu_torch.opt.optax_adapter",
                                    "gparml_tpu_torch.models.sgpr",
                                    "gparml_tpu_torch.models.svgp",
                                    "gparml_tpu_torch.graft_entry"])
def test_cli_modules_load_no_jax(module):
    """Each module of the CLI path, imported alone in a fresh process, loads
    neither jax nor the JAX package."""
    code = (
        f"import sys, importlib; importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gparml_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_cli_help_runs_without_jax():
    res = _run(["-X", "importtime", "-m", "gparml_tpu_torch.cli", "--help"], cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert "--device" in res.stdout
    imported = {ln.split("|")[-1].strip().split(".")[0] for ln in res.stderr.splitlines()
                if ln.startswith("import time:")}
    assert not imported & {"jax", "gparml_tpu"}


@pytest.mark.parametrize("module", ["ops/psi_cuda.py", "ops/_build.py", "cli.py",
                                    "graft_entry.py"])
def test_kernel_paths_have_no_fallback(module):
    """No try/except around the build, the launch or the choice of device:
    a failure raises."""
    tree = ast.parse((PKG / module).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


EXAMPLES = sorted(p.stem for p in (ROOT / "examples" / "torch").glob("*.py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_load_no_jax(name):
    """Each of the port's examples (examples/torch/) names neither jax nor
    the JAX package, and importing it in a fresh process loads neither."""
    path = ROOT / "examples" / "torch" / f"{name}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                node.module or ""]
            assert not {n.split(".")[0] for n in names} & {"jax", "gparml_tpu"}, (name, names)
    code = (
        f"import sys; sys.path.insert(0, {str(path.parent)!r}); import {name}\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gparml_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = _run(["-c", code], cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_fails_without_a_gpu():
    res = _run(["chip_smoke.py"], cwd=ROOT, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
