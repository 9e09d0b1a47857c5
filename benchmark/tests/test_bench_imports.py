"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program: compared by whole top-level
names (``srf_tpu_torch`` is not ``srf_tpu``)."""

import ast
import os
import sys

import pytest

from benchmark import harness


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not (
                node.level):
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources(sub=""):
    base = os.path.join(harness.BENCH_DIR, sub)
    for folder, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(folder, name)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_import(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & {"srf_tpu_torch", "srf_tpu"}


def test_runtime_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "srf_tpu_torch_fake", object())
    assert "srf_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert harness.forbidden_loaded() == ["flax"]
