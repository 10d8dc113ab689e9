"""Nothing under ``portbench/`` imports JAX or the JAX package, comparing the
top-level module name whole (``yagi_tpu_torch`` begins with ``yagi_tpu``),
and nothing under ``portbench/reference/`` imports the program."""

import ast
import sys

import pytest

from portbench.core import registry, runner

FILES = sorted(p for p in registry.PKG.rglob("*.py"))


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(registry.PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & set(runner.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((registry.PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "numpy", "torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("jax", "jax.numpy", "yagi_tpu.chains", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    found = runner.forbidden_modules()
    assert {"jax", "jax.numpy", "yagi_tpu.chains", "flax"} <= set(found)
    assert not [m for m in found if m.startswith(("yagi_tpu_torch", "jaxtyping_like"))]
