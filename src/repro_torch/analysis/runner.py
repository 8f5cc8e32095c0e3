"""Drive one analysis run: collect files, parse, run rules, suppress.

``analyze_paths`` is the single entry point the CLI and the tier-1
self-run test share.  Unparseable files surface as a ``parse``-rule
violation rather than crashing the run, so one broken file cannot mask
findings elsewhere.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

from .context import ModuleInfo, ProjectContext, build_module
from .pragmas import Pragma, apply_pragmas, parse_pragmas
from .registry import Rule, all_rules, get_rule
from .report import Report, Violation

_SKIP_DIRS = frozenset({"__pycache__", ".git", ".mypy_cache",
                        ".ruff_cache", ".pytest_cache"})


def collect_py_files(paths: Iterable[str]) -> List[str]:
    """Every ``.py`` file under ``paths`` (files pass through verbatim),
    sorted, hidden and cache directories skipped."""
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                out.append(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d for d in dirs
                if d not in _SKIP_DIRS and not d.startswith("."))
            for fn in sorted(files):
                if fn.endswith(".py"):
                    out.append(os.path.join(root, fn))
    return sorted(dict.fromkeys(out))


def _relpath(path: str, roots: List[str]) -> str:
    best: Optional[str] = None
    for root in roots:
        if os.path.isdir(root):
            try:
                rel = os.path.relpath(path, root)
            except ValueError:  # pragma: no cover - windows drives
                continue
            if not rel.startswith(".."):
                if best is None or len(rel) < len(best):
                    best = rel
    rel = best if best is not None else path
    return rel.replace(os.sep, "/")


def analyze_paths(paths: Iterable[str],
                  select: Optional[Iterable[str]] = None) -> Report:
    """Run every rule (or just ``select``) over the tree under ``paths``
    and return the full :class:`Report`, pragmas applied."""
    roots = [p for p in paths if os.path.isdir(p)]
    files = collect_py_files(paths)
    rules: List[Rule] = (
        [get_rule(n) for n in select] if select else all_rules())
    known = frozenset(r.name for r in rules) | frozenset(
        r.name for r in all_rules())

    modules: List[ModuleInfo] = []
    violations: List[Violation] = []
    pragmas_by_path: Dict[str, Dict[int, Pragma]] = {}
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as exc:
            violations.append(Violation(
                rule="parse", path=path, line=1, col=0,
                message=f"cannot read file: {exc}"))
            continue
        try:
            mod = build_module(path, _relpath(path, roots), source)
        except SyntaxError as exc:
            violations.append(Violation(
                rule="parse", path=path, line=exc.lineno or 1,
                col=exc.offset or 0,
                message=f"syntax error: {exc.msg}"))
            continue
        modules.append(mod)
        pragmas, malformed = parse_pragmas(
            path, mod.lines, known_rules=known)
        pragmas_by_path[path] = pragmas
        violations.extend(malformed)

    ctx = ProjectContext(modules=modules)
    for rule in rules:
        for mod in modules:
            violations.extend(rule.check_module(mod, ctx))
        violations.extend(rule.check_project(ctx))

    out: List[Violation] = []
    by_path: Dict[str, List[Violation]] = {}
    for v in violations:
        by_path.setdefault(v.path, []).append(v)
    for path, vs in by_path.items():
        out.extend(apply_pragmas(vs, pragmas_by_path.get(path, {})))
    return Report(violations=out, files_checked=len(files))


def split_selection(spec: str) -> Tuple[str, ...]:
    """``"a,b , c"`` -> ``("a", "b", "c")`` (for ``--select``)."""
    return tuple(p.strip() for p in spec.split(",") if p.strip())
