"""``f64-discipline``: float32 must not leak into exactness-critical code.

The guard-band contract (``index/device_state.py``) is that ``core/``
and ``index/`` decide clustering *exactly* in float64 on the host;
float32 appears only inside the designated kernel-dispatch functions,
which center coordinates and apply the guard band so that float32 only
decides provably-certain cases.  A stray ``.float()`` or an f32-vs-f64
comparison anywhere else silently converts "exact DBSCAN" into
"approximately DBSCAN".

Flags, inside ``core/`` and ``index/`` but outside the allowlisted
dispatch functions:

* references of ``torch.float32`` / ``torch.float`` / ``np.float32``
  (``.to(torch.float32)``, ``dtype=torch.float32``) and calls of
  ``np.float32(...)``;
* ``.float()`` and ``.astype("float32")`` casts, and ``dtype="float32"``
  string dtypes;
* comparisons where exactly one side is f32-tainted (a name assigned
  from an expression involving float32) -- the classic mixed-precision
  threshold bug.

``dist/`` and ``engine/`` are out of scope, as in the JAX package: the
device pipeline they feed runs on float32 coordinates by design and is
held to the float64 engines by the differential tests.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..context import (FunctionUnit, ModuleInfo, ProjectContext,
                       dotted_name, iter_assignments)
from ..registry import Rule, register_rule
from ..report import Violation

_F32_NAMES = frozenset({
    "torch.float32", "torch.float", "np.float32", "numpy.float32",
})
_F32_STRINGS = frozenset({"float32", "f4"})

#: (module relpath suffix, unit qualname) pairs where float32 is the
#: point: the kernel-dispatch layer that owns the guard-band contract --
#: the JAX package's list, function for function
#: (``fast_merging_batch`` is the twin of its ``fast_merging_masked``).
ALLOWLIST: Set[Tuple[str, str]] = {
    ("core/merging.py", "fast_merging_batch"),
    ("core/grids.py", "build_grids_device"),
    ("index/grit_index.py", "GritIndex._predict_kernel"),
    ("index/device_state.py", "DeviceState.refresh_rows"),
    ("index/device_state.py", "DeviceState.mirror_matches"),
    ("index/device_state.py", "_d2_flat_res"),
    ("index/device_state.py", "_anchors"),
    ("index/device_state.py", "predict_device_async"),
}


def _in_scope(mod: ModuleInfo) -> bool:
    parts = mod.path_parts()
    return "core" in parts or "index" in parts


def _allowlisted(mod: ModuleInfo, unit: FunctionUnit) -> bool:
    for suffix, qual in ALLOWLIST:
        if mod.relpath.endswith(suffix) and unit.qualname == qual:
            return True
    return False


def _f32_cast(call: ast.Call) -> Optional[str]:
    """How ``call`` casts to float32 without naming a dtype attribute:
    ``.float()`` or ``.astype("float32")``."""
    if not isinstance(call.func, ast.Attribute):
        return None
    if call.func.attr == "float" and not call.args:
        return ".float()"
    if call.func.attr == "astype":
        for arg in call.args:
            if isinstance(arg, ast.Constant) and arg.value in _F32_STRINGS:
                return f"astype('{arg.value}')"
    return None


def _mentions_f32(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and \
                dotted_name(sub) in _F32_NAMES:
            return True
        if isinstance(sub, ast.Call) and _f32_cast(sub) is not None:
            return True
    return False


@register_rule
class F64Discipline(Rule):
    name = "f64-discipline"
    description = ("float32 cast or mixed f32/f64 comparison in core/ "
                   "or index/ outside the kernel-dispatch allowlist")

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Violation]:
        if not _in_scope(mod):
            return []
        out: List[Violation] = []
        for unit in mod.units:
            if _allowlisted(mod, unit):
                continue
            out.extend(self._check_unit(mod, unit))
        return out

    def _check_unit(self, mod: ModuleInfo,
                    unit: FunctionUnit) -> List[Violation]:
        out: List[Violation] = []
        flagged_funcs: Set[int] = set()
        for node in ast.walk(unit.node):
            if isinstance(node, ast.Call):
                v = self._check_call(mod, node, flagged_funcs)
                if v is not None:
                    out.append(v)
        for node in ast.walk(unit.node):
            if isinstance(node, ast.Attribute) and \
                    id(node) not in flagged_funcs and \
                    dotted_name(node) in _F32_NAMES:
                out.append(Violation(
                    rule=self.name, path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=f"float32 dtype '{dotted_name(node)}' in "
                            "exactness-critical code; f64 is the "
                            "reference here (guard-band contract)"))
        out.extend(self._check_mixed_compares(mod, unit))
        return out

    def _check_call(self, mod: ModuleInfo, node: ast.Call,
                    flagged_funcs: Set[int]) -> Optional[Violation]:
        func_name = dotted_name(node.func)
        if func_name in _F32_NAMES:
            flagged_funcs.add(id(node.func))
            return Violation(
                rule=self.name, path=mod.path, line=node.lineno,
                col=node.col_offset,
                message=f"float32 cast via {func_name}() in "
                        "exactness-critical code; keep core/index "
                        "decisions in f64 or move this into an "
                        "allowlisted dispatch function")
        cast = _f32_cast(node)
        if cast is not None:
            return Violation(
                rule=self.name, path=mod.path, line=node.lineno,
                col=node.col_offset,
                message=f"{cast} in exactness-critical code")
        for kw in node.keywords:
            if kw.arg == "dtype" and \
                    isinstance(kw.value, ast.Constant) and \
                    kw.value.value in _F32_STRINGS:
                return Violation(
                    rule=self.name, path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=f"dtype='{kw.value.value}' in "
                            "exactness-critical code")
        return None

    def _check_mixed_compares(self, mod: ModuleInfo,
                              unit: FunctionUnit) -> List[Violation]:
        tainted: Set[str] = set()
        for names, value, _line in sorted(
                iter_assignments(unit.node), key=lambda t: t[2]):
            if _mentions_f32(value) or any(
                    isinstance(s, ast.Name) and s.id in tainted
                    for s in ast.walk(value)):
                tainted.update(names)

        def side_f32(expr: ast.AST) -> bool:
            if _mentions_f32(expr):
                return True
            return any(isinstance(s, ast.Name) and s.id in tainted
                       for s in ast.walk(expr))

        out: List[Violation] = []
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Compare):
                continue
            if len(node.comparators) != 1:
                continue
            lhs, rhs = node.left, node.comparators[0]
            if side_f32(lhs) != side_f32(rhs):
                out.append(Violation(
                    rule=self.name, path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message="comparison mixes an f32-tainted operand "
                            "with an untainted one; mixed-precision "
                            "thresholds break the exactness contract"))
        return out
