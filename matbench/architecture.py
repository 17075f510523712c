"""Which modules serve a configuration.  Its ``architecture`` key names one
module on each side of the program boundary:

* ``matbench/programs/<architecture>.py``: the program under test, built
  from the configuration (see ``program.py`` for what it exposes), and
* ``matbench/reference/<architecture>_ref.py``: the plain reference of the
  same call (see ``reference/__init__.py``).

Both are found by name along their packages' paths.  A configuration
without the key, or naming an architecture that lacks either module, is
refused: there is no default.
"""

from __future__ import annotations

import importlib
import pkgutil

from . import programs, reference

REF_SUFFIX = "_ref"


def known() -> list[str]:
    """The architectures that have both modules."""
    progs = {m.name for m in pkgutil.iter_modules(programs.__path__)}
    refs = {m.name[:-len(REF_SUFFIX)] for m in pkgutil.iter_modules(reference.__path__)
            if m.name.endswith(REF_SUFFIX)}
    return sorted(progs & refs)


def name_of(conf: dict) -> str:
    """The configuration's architecture; a missing or unknown one is refused."""
    arch = conf.get("architecture")
    names = known()
    if arch not in names:
        what = ("names no architecture" if arch is None
                else f"names the architecture {arch!r}, which has no modules")
        raise SystemExit(f"matbench: the configuration {conf.get('name')!r} {what}; known: "
                         f"{', '.join(names)}")
    return arch


def program_of(conf: dict):
    """``matbench/programs/<architecture>.py`` of the configuration."""
    return importlib.import_module(f"{programs.__name__}.{name_of(conf)}")


def reference_of(conf: dict):
    """``matbench/reference/<architecture>_ref.py`` of the configuration."""
    return importlib.import_module(f"{reference.__name__}.{name_of(conf)}{REF_SUFFIX}")
