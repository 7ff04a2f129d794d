"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name
(the part before the first dot) compared whole, so that
``heyoka_tpu_torch`` is not ``heyoka_tpu``."""

import ast
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert names <= {"__future__", "itertools", "math", "torch"}, names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types

    mods = dict.fromkeys(["heyoka_tpu_torch", "heyoka_tpu_torch.taylor",
                          "jaxish", "torch"])
    monkeypatch.setattr(harness, "sys", types.SimpleNamespace(modules=mods))
    assert harness.forbidden_modules() == []
    mods["heyoka_tpu.taylor"] = mods["jax"] = None
    assert harness.forbidden_modules() == ["heyoka_tpu", "jax"]
