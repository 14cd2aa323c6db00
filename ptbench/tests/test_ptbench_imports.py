"""Nothing under ptbench/ imports the JAX side; the reference and the
yardstick import nothing of the program either."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from ptbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "pathtracer", "benchmarks", "bench",
             "chip_smoke"}
# the yardstick: these never import the program
PLAIN = ("reference", "scenes", "roofline", "metrics")


def _modules():
    for top, dirs, files in os.walk(spec.PKG_DIR):
        dirs[:] = [d for d in dirs if not d.startswith(".")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(top, f)


def top_level_imports(path) -> set:
    """Top-level names (before the first dot) of every import in a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, spec.PKG_DIR))
def test_no_jax_side_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in _modules()
    if os.path.relpath(p, spec.PKG_DIR).split(os.sep)[0] in PLAIN),
    ids=lambda p: os.path.relpath(p, spec.PKG_DIR))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "pathtracer_torch" not in top_level_imports(path)


def test_import_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import pathtracer_torch.render\nfrom jax import numpy\n"
                 "import benchmarks_extra\n")
    assert top_level_imports(str(p)) == {"pathtracer_torch", "jax",
                                         "benchmarks_extra"}
    assert top_level_imports(str(p)) & FORBIDDEN == {"jax"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pathtracer_torch_fake", object())
    assert "pathtracer_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pathtracer.fake", object())
    assert "pathtracer.fake" in run.forbidden_modules()
