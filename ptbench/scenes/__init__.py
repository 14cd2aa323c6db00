"""Frozen scene generators: the benchmark's traffic of geometry.

A configuration's `scene.generator` <name> is the module
ptbench/scenes/<name>.py, whose generate(**args) returns the
configuration's SceneSpec (ptbench.scenes.procedural), so a later scene
is a new module. Helper modules (procedural, rgbe) have no `generate`
and are refused by name.
"""

from __future__ import annotations

import importlib
import pkgutil


def names() -> list:
    """Every generator there is: the modules here with a `generate`."""
    found = []
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        if callable(getattr(mod, "generate", None)):
            found.append(info.name)
    return sorted(found)


def module(name: str):
    """ptbench/scenes/<name>.py, refused unless it has a `generate`."""
    mod = None
    if name.isidentifier():
        try:
            mod = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
    if mod is None or not callable(getattr(mod, "generate", None)):
        raise ValueError(f"unknown scene generator {name!r}: expected one "
                         f"of {', '.join(names())}")
    return mod


def generate(name: str, args: dict):
    """The SceneSpec of generator `name` called with `args`."""
    return module(name).generate(**args)
