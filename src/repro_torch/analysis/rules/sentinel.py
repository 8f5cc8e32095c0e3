"""``sentinel-mask``: reductions over padded buffers must mask first.

Kernel operands are padded to slot capacities, and a padded candidate
slot holds whatever the buffer held (zeros, or a far-away coordinate);
a ``min`` / ``argmin`` straight over such a buffer happily returns a
padding slot whenever the valid prefix is empty -- or, worse, a *wrong*
argmin when a padding slot is nearer than every valid one.  The plain
versions of the kernels therefore fold the validity mask
(``torch.where(valid, d2, torch.inf)``) before every reduction.

This rule flags, in ``kernels/``, any ``min`` / ``amin`` / ``argmin`` /
``aminmax`` (``torch.`` / ``np.`` function form on its first argument,
or method form on its receiver) whose operand does not derive from a
``where`` / ``masked_fill`` fold -- directly, or via a name assigned
(with one propagation step) from such a fold.

The JAX package exempts its Pallas kernel *bodies* (functions taking
``*_ref`` parameters).  The port's kernel bodies are CUDA C++ in
``kernels/csrc/*.cu``, which this Python linter does not read, so there
is no exemption here: every Python function in ``kernels/`` -- the
wrappers, the plain versions in ``kernels/ops.py`` and the oracles in
``kernels/ref.py`` -- is held to the rule.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..context import (FunctionUnit, ModuleInfo, ProjectContext,
                       dotted_name, iter_assignments, simple_callee)
from ..registry import Rule, register_rule
from ..report import Violation

_REDUCERS = frozenset({"min", "amin", "argmin", "aminmax", "nanmin",
                       "nanargmin"})
_REDUCER_MODULES = ("torch.", "np.", "numpy.")
_FOLDS = frozenset({"where", "masked_fill", "masked_fill_"})


def _in_scope(mod: ModuleInfo) -> bool:
    return "kernels" in mod.path_parts()


def _has_fold(node: ast.AST) -> bool:
    return any(isinstance(sub, ast.Call) and simple_callee(sub) in _FOLDS
               for sub in ast.walk(node))


def _masked_names(unit: FunctionUnit) -> Set[str]:
    """Names assigned from a mask fold, plus one propagation step
    (a name assigned from an expression mentioning a masked name)."""
    masked: Set[str] = set()
    assignments = sorted(iter_assignments(unit.node),
                         key=lambda t: t[2])
    for _pass in range(2):
        for names, value, _line in assignments:
            if _has_fold(value) or any(
                    isinstance(s, ast.Name) and s.id in masked
                    for s in ast.walk(value)):
                masked.update(n for n in names if "." not in n)
    return masked


def _operand_masked(operand: ast.AST, masked: Set[str]) -> bool:
    if _has_fold(operand):
        return True
    return any(isinstance(s, ast.Name) and s.id in masked
               for s in ast.walk(operand))


@register_rule
class SentinelMask(Rule):
    name = "sentinel-mask"
    description = ("raw min/argmin over a padded buffer in kernels/ "
                   "without a preceding validity-mask fold")

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Violation]:
        if not _in_scope(mod):
            return []
        out: List[Violation] = []
        for unit in mod.units:
            out.extend(self._check_unit(mod, unit))
        return out

    def _check_unit(self, mod: ModuleInfo,
                    unit: FunctionUnit) -> List[Violation]:
        masked = _masked_names(unit)
        out: List[Violation] = []
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Call):
                continue
            operand = self._reduction_operand(node)
            if operand is None:
                continue
            if not _operand_masked(operand, masked):
                out.append(Violation(
                    rule=self.name, path=mod.path, line=node.lineno,
                    col=node.col_offset,
                    message=("raw reduction over a possibly padded "
                             "buffer; fold the validity mask first "
                             "(torch.where(valid, d2, torch.inf)) or "
                             "the padding slots can win")))
        return out

    @staticmethod
    def _reduction_operand(node: ast.Call) -> Optional[ast.expr]:
        callee = node.func
        if not isinstance(callee, ast.Attribute) or \
                callee.attr not in _REDUCERS:
            return None
        dn = dotted_name(callee)
        if dn is not None and dn.startswith(_REDUCER_MODULES):
            return node.args[0] if node.args else None
        # method form: buf.min() / buf.min(dim=-1) / buf.argmin(-1)
        return callee.value
