"""``recompile-hazard``: kernel operands must route through bucketing.

The port compiles nothing per shape (``kernels/build.py`` hashes the
source text and flags), but the shape and the scalars of a launch still
key per-call state: one launch geometry and one allocator size class per
batch size, and -- where a step is captured into a CUDA graph -- one
capture per distinct shape and per distinct host scalar baked into it.
The serving stack keeps that set bounded by padding data-dependent sizes
through the bucketing helpers (``_pow2_at_least`` / ``_pad_pow2`` /
``_pad_rows`` / ``_pad_feat``) and the persisted ``*_cap`` attributes
before anything reaches a kernel.  This rule flags two ways a change can
silently make that set grow with the traffic:

* a kernel operator (``context.py``) fed ``torch.as_tensor(x)`` /
  ``torch.from_numpy(x)`` / ``torch.tensor(x)`` / ``torch.asarray(x)``
  where ``x`` involves a locally-assigned array that never went through
  a bucketing helper (raw data-dependent shape -> one geometry per batch
  size);
* a tensor-derived value (``t.item()``, ``float(t)`` / ``int(t)`` of a
  tensor expression) passed to an operator's scalar schema argument
  (``float eps2``, ``int stop_at``): a wait for the card at every call,
  and a capture per value under a CUDA graph.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..context import (FunctionUnit, KernelSpec, ModuleInfo,
                       ProjectContext, dotted_name, iter_assignments,
                       simple_callee)
from ..registry import Rule, register_rule
from ..report import Violation

#: helpers whose output is shape-bucketed by construction
BUCKETING_HELPERS = frozenset({
    "_pow2_at_least", "_pad_pow2", "_pad_rows", "_pad_feat",
})

_CONVERTERS = frozenset({
    "torch.as_tensor", "torch.from_numpy", "torch.tensor",
    "torch.asarray",
})
#: scalar conversions that read a tensor back to the host
_SCALAR_READS = frozenset({"float", "int", "bool"})


def _bucketed_names(unit: FunctionUnit) -> Set[str]:
    """Names assigned (in source order) from a bucketing helper, a
    ``*_cap`` attribute, or another bucketed name."""
    bucketed: Set[str] = set()

    def value_is_bucketed(value: ast.AST) -> bool:
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call) and \
                    simple_callee(sub) in BUCKETING_HELPERS:
                return True
            if isinstance(sub, ast.Attribute) and \
                    sub.attr.endswith("_cap"):
                return True
            if isinstance(sub, ast.Name) and sub.id in bucketed:
                return True
        return False

    for names, value, _line in sorted(
            iter_assignments(unit.node), key=lambda t: t[2]):
        if value_is_bucketed(value):
            bucketed.update(n for n in names if "." not in n)
    return bucketed


def _assigned_names(unit: FunctionUnit) -> Set[str]:
    out: Set[str] = set()
    for names, _value, _line in iter_assignments(unit.node):
        out.update(n for n in names if "." not in n)
    return out


def _tensor_expr(expr: ast.AST) -> bool:
    """A tensor expression: a ``torch.`` call or a method call on one
    (``t.amax()``), as far as the syntax shows."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            dn = dotted_name(sub.func) or ""
            if dn.startswith("torch."):
                return True
            if isinstance(sub.func, ast.Attribute) and \
                    not dn.startswith(("np.", "numpy.", "math.")):
                return True
    return False


def _tensor_scalar(expr: ast.AST) -> bool:
    """``t.item()``, or ``float`` / ``int`` / ``bool`` of a tensor
    expression, anywhere in ``expr``."""
    for sub in ast.walk(expr):
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Attribute) and \
                sub.func.attr == "item" and not sub.args:
            return True
        if isinstance(sub.func, ast.Name) and \
                sub.func.id in _SCALAR_READS and sub.args and \
                _tensor_expr(sub.args[0]):
            return True
    return False


@register_rule
class RecompileHazard(Rule):
    name = "recompile-hazard"
    description = ("kernel operator fed raw data-dependent shapes that "
                   "skip pow2 bucketing, or a tensor-derived value in a "
                   "scalar schema argument")

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Violation]:
        out: List[Violation] = []
        for unit in mod.units:
            out.extend(self._check_unit(mod, ctx, unit))
        return out

    def _check_unit(self, mod: ModuleInfo, ctx: ProjectContext,
                    unit: FunctionUnit) -> List[Violation]:
        out: List[Violation] = []
        bucketed = _bucketed_names(unit)
        assigned = _assigned_names(unit)
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Call):
                continue
            spec = ctx.resolve_kernel_callee(mod, node)
            if spec is None:
                continue
            callee = dotted_name(node.func) or "<kernel>"
            out.extend(self._check_raw_shapes(
                mod, node, callee, bucketed, assigned))
            out.extend(self._check_scalar_args(mod, node, callee, spec))
        return out

    def _check_raw_shapes(self, mod: ModuleInfo, call: ast.Call,
                          callee: str, bucketed: Set[str],
                          assigned: Set[str]) -> List[Violation]:
        out: List[Violation] = []
        args = list(call.args) + [kw.value for kw in call.keywords]
        for arg in args:
            for sub in ast.walk(arg):
                if not isinstance(sub, ast.Call):
                    continue
                if dotted_name(sub.func) not in _CONVERTERS:
                    continue
                raw = self._raw_name(sub, bucketed, assigned)
                if raw is not None:
                    out.append(Violation(
                        rule=self.name, path=mod.path,
                        line=sub.lineno, col=sub.col_offset,
                        message=(f"{callee}() is fed a tensor built "
                                 f"from '{raw}', whose shape never went "
                                 "through a bucketing helper "
                                 "(_pad_pow2/_pow2_at_least); each "
                                 "distinct size is a new launch "
                                 "geometry and allocation class")))
        return out

    @staticmethod
    def _raw_name(conv: ast.Call, bucketed: Set[str],
                  assigned: Set[str]) -> Optional[str]:
        for sub in ast.walk(conv):
            if isinstance(sub, ast.Name) and sub.id in assigned and \
                    sub.id not in bucketed:
                return sub.id
        return None

    def _check_scalar_args(self, mod: ModuleInfo, call: ast.Call,
                           callee: str,
                           spec: KernelSpec) -> List[Violation]:
        out: List[Violation] = []
        scalars = [(spec.scalar_argnames[k], call.args[i])
                   for k, i in enumerate(spec.scalar_argnums)
                   if i < len(call.args)]
        scalars += [(kw.arg, kw.value) for kw in call.keywords
                    if kw.arg in spec.scalar_argnames]
        for name, value in scalars:
            if _tensor_scalar(value):
                out.append(Violation(
                    rule=self.name, path=mod.path,
                    line=value.lineno, col=value.col_offset,
                    message=(f"scalar argument '{name}' of {callee}() "
                             "receives a value read back from a tensor; "
                             "that waits for the card at every call and "
                             "bakes one value into each captured "
                             "graph")))
        return out
