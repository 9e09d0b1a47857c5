"""The port's entry points for an installed package and for the recipes:
every ``srf-torch-*`` console script in ``pyproject.toml`` resolves to a
callable of ``srf_tpu_torch``; every JAX script but ``srf-export-tf-ckpt``
(held: its port waits for the reference toolkit) has its ``srf-torch-``
twin, pointing at the same module path in the port; and every recipe that
names ``srf_tpu.*`` has its port's copy under ``egs/script/torch/``, which
names only ``srf_tpu_torch`` modules that import and keeps the recipe's
stages (its ``run``/``python -m`` lines, module for module) and flags."""

import importlib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = os.path.join(REPO, "egs", "script")
PORT_RECIPES = os.path.join(RECIPES, "torch")
HELD = {"srf-export-tf-ckpt"}


def _scripts():
    text = open(os.path.join(REPO, "pyproject.toml")).read()
    block = text.split("[project.scripts]")[1].split("[tool.")[0]
    return {name: (module, attr) for name, module, attr in re.findall(
        r'^([\w-]+) = "([\w.]+):(\w+)"', block, re.M)}


def test_every_torch_script_resolves_into_the_port():
    torch_scripts = {k: v for k, v in _scripts().items()
                     if k.startswith("srf-torch-")}
    assert len(torch_scripts) == 9
    for name, (module, attr) in torch_scripts.items():
        assert module.startswith("srf_tpu_torch."), name
        assert callable(getattr(importlib.import_module(module), attr)), name


def test_every_jax_script_but_the_held_one_has_a_twin():
    scripts = _scripts()
    jax = {k: v for k, v in scripts.items() if not k.startswith("srf-torch-")}
    assert HELD <= set(jax)
    for name, (module, attr) in jax.items():
        twin = "srf-torch-" + name[len("srf-"):]
        if name in HELD:
            assert twin not in scripts
            continue
        assert scripts[twin] == (module.replace("srf_tpu.", "srf_tpu_torch.",
                                                1), attr), name


def _recipes():
    return sorted(n for n in os.listdir(RECIPES) if n.endswith(".sh") and
                  re.search(r"\bsrf_tpu\.", open(os.path.join(RECIPES,
                                                              n)).read()))


def test_every_recipe_naming_srf_tpu_has_the_ports_copy():
    recipes = _recipes()
    assert len(recipes) >= 12
    ported = sorted(n for n in os.listdir(PORT_RECIPES) if n.endswith(".sh"))
    assert ported == recipes


def _code(text):
    """A script's lines but its comments."""
    return "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("#"))


def _stages(text, package):
    """The modules a script runs, in order: its `run <module>` and
    `python -m <module>` lines."""
    return re.findall(r"(?:^run|python -u -m|python -m) (%s\.[\w.]+)"
                      % re.escape(package), _code(text), re.M)


def _flags(text):
    return sorted(set(re.findall(r"(--[a-z][\w-]*)", _code(text))))


@pytest.mark.parametrize("name", _recipes())
def test_each_ported_recipe_runs_the_port_at_its_recipes_stages(name):
    recipe = open(os.path.join(RECIPES, name)).read()
    ported = open(os.path.join(PORT_RECIPES, name)).read()
    assert os.access(os.path.join(PORT_RECIPES, name), os.X_OK)
    assert not re.search(r"\bsrf_tpu\.", ported), name
    stages = _stages(ported, "srf_tpu_torch")
    assert stages == [s.replace("srf_tpu.", "srf_tpu_torch.", 1)
                      for s in _stages(recipe, "srf_tpu")], name
    assert _flags(ported) == _flags(recipe), name
    for module in set(re.findall(r"\b(srf_tpu_torch(?:\.\w+)+)", ported)):
        importlib.import_module(module)
