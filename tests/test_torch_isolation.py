"""The port stands alone: it imports neither ``jax`` nor anything of the
JAX package, so it runs on a machine that has neither."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_tensorflow_examples_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "distributed_tensorflow_examples_tpu")


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield path, ".".join(parts)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_port_module_pulls_in_no_jax():
    names = [name for _path, name in _modules()]
    assert len(names) > 15
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", [p for p, _n in _modules()], ids=lambda p: p.name)
def test_no_port_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = (
                [a.name for a in node.names] if isinstance(node, ast.Import)
                else [node.module or ""]
            )
            assert not [n for n in names if _forbidden(n)], node.lineno


def test_native_loader_builds_the_ports_own_source():
    """The port's native services compile its own ``native/accumulator.cc``
    into ``build/native/`` at the root of the checkout."""
    from distributed_tensorflow_examples_tpu_torch import native

    assert native.SOURCE == PORT / "native" / "accumulator.cc"
    assert native.SOURCE.is_file()
    assert native.BUILD_DIR == ROOT / "build" / "native"
    assert native.library_path().parent == native.BUILD_DIR
    native.GradientAccumulator(1)  # loads, building the library if needed
    assert native.library_path().is_file()


def test_no_port_file_names_the_jax_native_library():
    bad = ("distributed_tensorflow_examples_tpu/native", "libdtx_native")
    for path in sorted(PORT.rglob("*")):
        if path.is_file() and path.suffix in (".py", ".cc", ".cu", ".cuh", ".h"):
            text = path.read_text()
            assert not [b for b in bad if b in text], path.relative_to(ROOT)
