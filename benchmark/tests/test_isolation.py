"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level names are compared
whole: the program's name begins with the JAX package's."""

from __future__ import annotations

import ast

import pytest

from benchmark.spec import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tricolo_tpu"}


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "contextlib", "math", "itertools", "numpy", "torch"}


def test_the_run_check_compares_names_whole(monkeypatch):
    import sys

    from benchmark.run import forbidden_modules

    for name in FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "tricolo_tpu_torch_extra", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert forbidden_modules() == ["jaxlib"]
