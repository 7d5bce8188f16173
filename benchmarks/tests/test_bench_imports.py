"""Nothing under ``benchmarks/`` imports JAX or the JAX package, and the
plain reference imports nothing of the measured program either; top-level
module names are compared whole (the port's name begins with the JAX
package's)."""

from __future__ import annotations

import ast

import pytest

from bench_small import BENCH_DIR

JAX = {"jax", "jaxlib", "flax", "pytorch_scalablefhvae_tpu"}
PORT = "pytorch_scalablefhvae_tpu_torch"


def imported_roots(path) -> set:
    """Top-level names of every module ``path`` imports, statically."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH_DIR)) for p in SOURCES])
def test_no_jax_import(path):
    assert not imported_roots(path) & JAX
    if "tests" not in path.parts:
        # nothing reads the JAX package's benchmark or its results
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_r" not in text


@pytest.mark.parametrize("path",
                         sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in imported_roots(path)
    assert PORT not in path.read_text()


def test_names_compare_whole():
    # the port's own top-level name is not the JAX package's
    assert PORT not in JAX and PORT.startswith("pytorch_scalablefhvae_tpu")


def test_run_refuses_jax_in_sys_modules(monkeypatch):
    import sys
    import types

    from fhbench import device

    assert device.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    monkeypatch.setitem(sys.modules, PORT + "_x", types.ModuleType("x"))
    assert "jaxlib" in device.forbidden_modules()
    assert PORT + "_x" not in device.forbidden_modules()
