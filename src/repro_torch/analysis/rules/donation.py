"""``donation-aliasing``: reads through a stale alias.

The JAX package donates buffers to jitted callables, and its rule flags
a read of a donated binding.  PyTorch donates nothing; its counterpart
hazard is storage shared by two bindings.  A slice, ``.view`` /
``.reshape`` / ``.expand`` / ``.narrow`` / ``.t()`` / ``.detach()``,
``torch.from_numpy`` or ``.numpy()`` binds a second name to the first
one's storage, and an in-place write through that alias silently
changes the first binding too::

    head = state.alive_res[:n]
    head.zero_()                    # writes state.alive_res as well
    keep = state.alive_res.sum()    # reads what head wrote

This rule flags a *load* of the aliased binding after an in-place write
through the alias (a ``_``-suffixed method, an ``out=`` argument, a
subscript store or an augmented assignment) and before any rebind of
either name.  Control flow is approximated linearly by source position
(a read earlier in a loop body is not caught -- the rule is a tripwire
for the common straight-line bug, not a dataflow engine), and only
within one function: an alias that crosses functions, such as a
snapshot that returns the index's own arrays, is out of its reach.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ..context import FunctionUnit, ModuleInfo, ProjectContext, dotted_name
from ..registry import Rule, register_rule
from ..report import Violation

#: methods whose result shares the receiver's storage
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "expand", "expand_as", "narrow", "t",
    "detach", "numpy", "transpose", "permute", "squeeze", "unsqueeze",
    "flatten", "unflatten",
})
_VIEW_FUNCS = frozenset({"torch.from_numpy"})

_SIMPLE_STMTS = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr,
                 ast.Return)


def _pos(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def _end_pos(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "end_lineno", 0) or 0,
            getattr(node, "end_col_offset", 0) or 0)


def _basic_index(node: ast.AST) -> bool:
    """An index that gives a view: slices, ``...``, ``None`` and
    integer constants (a tensor or list index gives a copy)."""
    if isinstance(node, ast.Tuple):
        return all(_basic_index(e) for e in node.elts)
    if isinstance(node, ast.Slice):
        return True
    return isinstance(node, ast.Constant) and (
        node.value is None or node.value is Ellipsis
        or isinstance(node.value, int))


def _view_base(value: ast.AST) -> Optional[str]:
    """The dotted name whose storage ``value`` shares, else None."""
    if isinstance(value, ast.Subscript) and _basic_index(value.slice):
        return dotted_name(value.value) or _view_base(value.value)
    if isinstance(value, ast.Call):
        if dotted_name(value.func) in _VIEW_FUNCS and value.args:
            return dotted_name(value.args[0])
        if isinstance(value.func, ast.Attribute) and \
                value.func.attr in _VIEW_METHODS:
            return dotted_name(value.func.value) or \
                _view_base(value.func.value)
    return None


def _writes(stmt: ast.AST, alias: str) -> bool:
    """True when ``stmt`` writes in place through ``alias``."""
    if isinstance(stmt, ast.Assign):
        return any(isinstance(t, ast.Subscript)
                   and dotted_name(t.value) == alias for t in stmt.targets)
    if isinstance(stmt, ast.AugAssign):
        t = stmt.target
        return dotted_name(t) == alias or (
            isinstance(t, ast.Subscript) and dotted_name(t.value) == alias)
    for sub in ast.walk(stmt):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        if isinstance(f, ast.Attribute) and f.attr.endswith("_") and \
                not f.attr.startswith("_") and \
                dotted_name(f.value) == alias:
            return True
        if any(kw.arg == "out" and dotted_name(kw.value) == alias
               for kw in sub.keywords):
            return True
    return False


def _stmt_rebinds(stmt: ast.stmt, name: str) -> bool:
    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        stack: List[ast.AST] = list(targets)
        while stack:
            tgt = stack.pop()
            if isinstance(tgt, (ast.Tuple, ast.List)):
                stack.extend(tgt.elts)
            elif isinstance(tgt, ast.Starred):
                stack.append(tgt.value)
            elif dotted_name(tgt) == name:
                return True
    return False


@register_rule
class DonationAliasing(Rule):
    name = "donation-aliasing"
    description = ("read of a binding after an in-place write through "
                   "an alias of its storage, before rebinding")

    def check_module(self, mod: ModuleInfo,
                     ctx: ProjectContext) -> List[Violation]:
        out: List[Violation] = []
        for unit in mod.units:
            out.extend(self._check_unit(mod, unit))
        return out

    def _check_unit(self, mod: ModuleInfo,
                    unit: FunctionUnit) -> List[Violation]:
        stmts = sorted((s for s in ast.walk(unit.node)
                        if isinstance(s, _SIMPLE_STMTS)), key=_pos)
        out: List[Violation] = []
        for i, stmt in enumerate(stmts):
            if not isinstance(stmt, ast.Assign) or \
                    len(stmt.targets) != 1:
                continue
            alias = dotted_name(stmt.targets[0])
            base = _view_base(stmt.value)
            if alias is None or base is None or alias == base:
                continue
            v = self._first_stale_read(mod, unit, stmts[i + 1:], alias,
                                       base, stmt.lineno)
            if v is not None:
                out.append(v)
        return out

    def _first_stale_read(self, mod: ModuleInfo, unit: FunctionUnit,
                          later: List[ast.stmt], alias: str, base: str,
                          bound_at: int) -> Optional[Violation]:
        write: Optional[ast.stmt] = None
        for stmt in later:
            if _writes(stmt, alias):
                write = stmt
                break
            if _stmt_rebinds(stmt, alias) or _stmt_rebinds(stmt, base):
                return None   # the alias is gone before any write
        if write is None or _stmt_rebinds(write, base):
            return None
        after = _end_pos(write)
        events: List[Tuple[Tuple[int, int], str]] = []
        for sub in ast.walk(unit.node):
            if not isinstance(sub, (ast.Name, ast.Attribute)):
                continue
            if dotted_name(sub) != base or _pos(sub) <= after:
                continue
            kind = ("store" if isinstance(sub.ctx, ast.Store)
                    else "load")
            events.append((_pos(sub), kind))
        for pos, kind in sorted(events):
            if kind == "store":
                return None  # rebound before any read
            return Violation(
                rule=self.name, path=mod.path, line=pos[0], col=pos[1],
                message=(f"'{base}' shares storage with '{alias}' "
                         f"(bound at line {bound_at}), which was written "
                         f"in place at line {write.lineno}; this read "
                         "sees that write -- copy (.clone()) or rebind "
                         "if the old values are meant"))
        return None
