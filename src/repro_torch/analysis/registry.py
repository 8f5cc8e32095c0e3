"""Rule registry: the analyzer's analogue of the engine registry.

Every invariant rule registers itself here under a short kebab-case
name (the name pragmas and ``--select`` refer to).  A rule is a class
with two hooks; implement whichever granularity the invariant needs:

* :meth:`Rule.check_module` -- per-file findings (most rules);
* :meth:`Rule.check_project` -- whole-tree findings (rules that need a
  cross-file call graph, e.g. ``hot-path-sync``).

Registering a new rule::

    @register_rule
    class MyRule(Rule):
        name = "my-rule"
        description = "..."
        def check_module(self, mod, ctx): ...
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Tuple, Type

from .report import Violation

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .context import ModuleInfo, ProjectContext


class Rule:
    """Base class of one invariant rule (see module docstring)."""

    name: str = ""
    description: str = ""

    def check_module(self, mod: "ModuleInfo",
                     ctx: "ProjectContext") -> List[Violation]:
        return []

    def check_project(self, ctx: "ProjectContext") -> List[Violation]:
        return []


_REGISTRY: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name:
        raise ValueError(f"rule class {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"rule {cls.name!r} already registered")
    _REGISTRY[cls.name] = cls
    return cls


def _ensure_loaded() -> None:
    # the built-in rules live in .rules; importing the package
    # populates the registry (same deferral idiom as engine.registry)
    from . import rules  # noqa: F401


def rule_names() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def get_rule(name: str) -> Rule:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown rule {name!r}; available: {rule_names()}")
    return _REGISTRY[name]()


def all_rules() -> List[Rule]:
    _ensure_loaded()
    return [_REGISTRY[n]() for n in sorted(_REGISTRY)]
