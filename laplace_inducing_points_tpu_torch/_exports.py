"""Lazy package exports.

Each subpackage's ``__init__`` names its public functions and classes, as the
reference's ``__init__`` files do, but imports the submodule that holds one
only when the name is first read (PEP 562). The submodules import each other
across subpackages (``inference`` uses ``training.inducing``'s Cholesky, the
α grid search in ``training`` serves through ``inference``), so eager imports
in the ``__init__`` files would run in circles; and importing a subpackage
stays as cheap as importing the one module a caller needs. No kernel library
is built or loaded by an import either way: that happens at a kernel's first
launch (``ops/cuda/_build.py``).
"""

from __future__ import annotations

import importlib
from typing import Callable


def lazy_exports(package: str, table: dict[str, str]) -> tuple[Callable, Callable]:
    """``(__getattr__, __dir__)`` for ``package`` from ``table``: public name
    -> ``"submodule"`` (the same name there) or ``"submodule:name"``."""

    def __getattr__(name: str):
        where = table.get(name)
        if where is None:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module, _, attr = where.partition(":")
        value = getattr(importlib.import_module(f"{package}.{module}"), attr or name)
        globals_of_package = importlib.import_module(package).__dict__
        globals_of_package[name] = value          # later reads skip this hook
        return value

    def __dir__() -> list[str]:
        return sorted(set(table) | set(importlib.import_module(package).__dict__))

    return __getattr__, __dir__
