"""Shared AST plumbing for the invariant rules.

One pass over each file builds a :class:`ModuleInfo` (function units,
locally-defined kernel operators with their scalar arguments,
kernel-ops import aliases); the :class:`ProjectContext` ties the files
of one run together for the rules that need cross-file knowledge (the
hot-path call graph, the scalar arguments of the
``repro_torch.kernels.ops`` wrappers and of the ``torch.ops.repro_torch``
operators they launch).

A *kernel operator* is what a jitted callable is to the JAX package: a
call that hands tensors to a hand-written kernel.  It is one of

* a ``repro_torch.kernels.ops`` wrapper, called through a module alias
  (``kernel_ops.row_min_batch(...)``) or a direct import;
* an operator of the ``repro_torch`` library
  (``torch.ops.repro_torch.<name>(...)``), whose schema is declared in
  ``kernels/ops.py`` by ``@_kernel_op("<name>", "(<schema>)")``;
* a function defined in the analyzed file with such a decorator, or with
  ``@torch.library.custom_op(...)``.

Its :class:`KernelSpec` lists the arguments that are host scalars in the
operator's schema (``float eps2``, ``int stop_at``): the counterpart of
``static_argnames``.

Scope note: rules analyze *function units* (top-level functions and
class methods; nested functions and lambdas are part of their enclosing
unit's tree).  Module-level statements outside any function are not
scanned -- none of the guarded invariants can be violated at import
time in this codebase.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

#: absolute module paths whose public callables are kernel wrappers
_KERNEL_OPS_MODULES = frozenset(
    {"repro_torch.kernels.ops", "repro_torch.kernels"})
#: the same modules imported relatively from inside the package
_KERNEL_OPS_RELATIVE = frozenset({"kernels.ops", "kernels"})
#: the namespace of the kernels' operators
_OPERATOR_PREFIX = "torch.ops.repro_torch."
#: ``torch.library.custom_op`` spellings
_CUSTOM_OP_CALLEES = frozenset({"torch.library.custom_op", "custom_op"})
#: schema types (and annotations) that reach the kernel as host scalars
_SCALAR_TYPES = frozenset({"int", "float", "bool"})
_SCHEMA_RE = re.compile(r"^\s*\((.*)\)\s*->")


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base is not None else None
    return None


def simple_callee(call: ast.Call) -> str:
    """The callee's simple name: ``f`` for ``f(...)`` and ``a.b.f(...)``,
    ``""`` for anything else."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return ""


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """The host-scalar arguments of one kernel operator or wrapper, by
    position and by name."""

    scalar_argnums: Tuple[int, ...] = ()
    scalar_argnames: Tuple[str, ...] = ()


def kernel_spec_of_schema(schema: str) -> Optional[KernelSpec]:
    """The :class:`KernelSpec` of an operator schema such as
    ``"(Tensor a, Tensor? va, float eps2, int stop_at) -> Tensor"``, or
    None when ``schema`` is not one."""
    m = _SCHEMA_RE.match(schema)
    if m is None:
        return None
    nums: List[int] = []
    names: List[str] = []
    pos = 0
    for part in m.group(1).split(","):
        words = part.split("=")[0].split()
        if not words or words == ["*"]:
            continue
        if len(words) == 2:
            typ, name = words[0].rstrip("?"), words[1]
            if typ in _SCALAR_TYPES:
                nums.append(pos)
                names.append(name)
        pos += 1
    return KernelSpec(scalar_argnums=tuple(nums),
                      scalar_argnames=tuple(names))


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _spec_of_annotations(node: ast.FunctionDef) -> KernelSpec:
    a = node.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    nums: List[int] = []
    names: List[str] = []
    for i, p in enumerate(params):
        if p.annotation is not None and \
                dotted_name(p.annotation) in _SCALAR_TYPES:
            nums.append(i)
            names.append(p.arg)
    return KernelSpec(scalar_argnums=tuple(nums),
                      scalar_argnames=tuple(names))


def operator_of_def(node: ast.FunctionDef
                    ) -> Optional[Tuple[Optional[str], KernelSpec]]:
    """``(operator name or None, spec)`` when ``node`` is decorated as a
    kernel operator (a decorator call given a name and a schema string,
    or ``torch.library.custom_op``), else None."""
    for dec in node.decorator_list:
        if not isinstance(dec, ast.Call):
            continue
        if dotted_name(dec.func) in _CUSTOM_OP_CALLEES and dec.args:
            qual = _const_str(dec.args[0]) or ""
            return qual.rsplit("::", 1)[-1] or None, \
                _spec_of_annotations(node)
        if len(dec.args) >= 2:
            name, schema = _const_str(dec.args[0]), _const_str(dec.args[1])
            if name is not None and schema is not None:
                spec = kernel_spec_of_schema(schema)
                if spec is not None:
                    return name, spec
    return None


@dataclasses.dataclass
class FunctionUnit:
    """One analyzable function: a top-level def or a class method.

    ``node`` includes any nested defs/lambdas -- rules walk the whole
    unit, so closures are analyzed in their enclosing unit's scope."""

    qualname: str              # "func" or "Class.method"
    node: ast.FunctionDef
    module_relpath: str
    kernel: Optional[KernelSpec] = None
    called_names: Set[str] = dataclasses.field(default_factory=set)

    @property
    def simple_name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    def param_names(self) -> List[str]:
        a = self.node.args
        params = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg is not None:
            params.append(a.vararg.arg)
        if a.kwarg is not None:
            params.append(a.kwarg.arg)
        return params


@dataclasses.dataclass
class ModuleInfo:
    """One parsed source file plus the lookups the rules share."""

    path: str                  # display path (as reported)
    relpath: str               # posix path relative to the scan root
    tree: ast.Module
    lines: List[str]
    units: List[FunctionUnit] = dataclasses.field(default_factory=list)
    #: locally-defined kernel operators (decorated defs), by local name
    kernel_defs: Dict[str, KernelSpec] = dataclasses.field(
        default_factory=dict)
    #: operators this file declares, by operator name
    operators: Dict[str, KernelSpec] = dataclasses.field(
        default_factory=dict)
    #: local names bound to the kernel-ops *module* (``kernel_ops.x``)
    kernel_module_aliases: Set[str] = dataclasses.field(
        default_factory=set)
    #: local names bound to individual kernel-ops callables
    kernel_func_aliases: Set[str] = dataclasses.field(default_factory=set)

    def path_parts(self) -> Tuple[str, ...]:
        return tuple(self.relpath.split("/"))


def _collect_units(mod: ModuleInfo) -> None:
    def add(node: ast.FunctionDef, qual: str) -> None:
        op = operator_of_def(node)
        unit = FunctionUnit(qualname=qual, node=node,
                            module_relpath=mod.relpath,
                            kernel=None if op is None else op[1])
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                callee = sub.func
                if isinstance(callee, ast.Name):
                    unit.called_names.add(callee.id)
                elif isinstance(callee, ast.Attribute):
                    unit.called_names.add(callee.attr)
        mod.units.append(unit)
        if op is not None:
            mod.kernel_defs[node.name] = op[1]
            if op[0]:
                mod.operators[op[0]] = op[1]

    for stmt in mod.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add(stmt, stmt.name)  # type: ignore[arg-type]
        elif isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    add(sub,  # type: ignore[arg-type]
                        f"{stmt.name}.{sub.name}")


def _is_kernel_ops_import(mod: ModuleInfo, node: ast.ImportFrom) -> bool:
    if node.level == 0:
        return node.module in _KERNEL_OPS_MODULES
    if node.module in _KERNEL_OPS_RELATIVE:
        return True
    # ``from . import ops`` / ``from .ops import x`` inside kernels/
    return "kernels" in mod.path_parts() and node.module in (None, "ops")


def _collect_kernel_aliases(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            if not _is_kernel_ops_import(mod, node):
                continue
            whole = (node.module or "").endswith("ops")
            for alias in node.names:
                local = alias.asname or alias.name
                if alias.name == "ops" and not whole:
                    mod.kernel_module_aliases.add(local)
                elif node.module is not None:
                    mod.kernel_func_aliases.add(local)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name in _KERNEL_OPS_MODULES and \
                        alias.name.endswith("ops"):
                    mod.kernel_module_aliases.add(
                        alias.asname or alias.name)


def build_module(path: str, relpath: str, source: str) -> ModuleInfo:
    """Parse one file into a :class:`ModuleInfo` (raises SyntaxError)."""
    tree = ast.parse(source, filename=path)
    mod = ModuleInfo(path=path, relpath=relpath, tree=tree,
                     lines=source.splitlines())
    _collect_units(mod)
    _collect_kernel_aliases(mod)
    return mod


def _operator_name(call: ast.Call) -> Optional[str]:
    """``name`` of a ``torch.ops.repro_torch.<name>[.default](...)``
    call, else None."""
    dn = dotted_name(call.func)
    if dn is None or not dn.startswith(_OPERATOR_PREFIX):
        return None
    return dn[len(_OPERATOR_PREFIX):].split(".")[0]


@dataclasses.dataclass
class ProjectContext:
    """Cross-file view of one analysis run."""

    modules: List[ModuleInfo]
    units_by_simple: Dict[str, List[FunctionUnit]] = dataclasses.field(
        default_factory=dict)
    #: every operator declared in the run, by operator name
    operators: Dict[str, KernelSpec] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self) -> None:
        for mod in self.modules:
            self.operators.update(mod.operators)
            for unit in mod.units:
                self.units_by_simple.setdefault(
                    unit.simple_name, []).append(unit)
        self._wrappers: Optional[Dict[str, KernelSpec]] = None

    def kernel_ops_module(self) -> Optional[ModuleInfo]:
        for mod in self.modules:
            if mod.relpath.endswith("kernels/ops.py"):
                return mod
        return None

    def wrapper_specs(self) -> Dict[str, KernelSpec]:
        """Per wrapper of ``kernels/ops.py`` that launches an operator:
        the wrapper's parameters that reach one of the operator's scalar
        arguments (``eps`` through ``_eps2(eps)`` into ``float eps2``)."""
        if self._wrappers is not None:
            return self._wrappers
        out: Dict[str, KernelSpec] = {}
        ops_mod = self.kernel_ops_module()
        for unit in (ops_mod.units if ops_mod is not None else []):
            params = unit.param_names()
            found: Dict[str, int] = {}
            for sub in ast.walk(unit.node):
                if not isinstance(sub, ast.Call):
                    continue
                spec = self.operators.get(_operator_name(sub) or "")
                if spec is None:
                    continue
                scalar_exprs = [sub.args[i] for i in spec.scalar_argnums
                                if i < len(sub.args)]
                scalar_exprs += [kw.value for kw in sub.keywords
                                 if kw.arg in spec.scalar_argnames]
                for expr in scalar_exprs:
                    for n in ast.walk(expr):
                        if isinstance(n, ast.Name) and n.id in params:
                            found[n.id] = params.index(n.id)
            if found:
                names = tuple(sorted(found, key=found.get))
                out[unit.simple_name] = KernelSpec(
                    scalar_argnums=tuple(found[n] for n in names),
                    scalar_argnames=names)
        self._wrappers = out
        return out

    def resolve_kernel_callee(self, mod: ModuleInfo,
                              call: ast.Call) -> Optional[KernelSpec]:
        """The :class:`KernelSpec` of a call site whose callee is a
        kernel operator (module docstring), else None.  Wrappers whose
        launch is not found (``kernels/ops.py`` outside the run, or a
        plain helper of it) resolve to an empty spec -- still a kernel
        entry."""
        name = dotted_name(call.func)
        if name is not None and name in mod.kernel_defs:
            return mod.kernel_defs[name]
        op = _operator_name(call)
        if op is not None:
            return self.operators.get(op, KernelSpec())
        target: Optional[str] = None
        callee = call.func
        if isinstance(callee, ast.Attribute):
            base = dotted_name(callee.value)
            if base is not None and base in mod.kernel_module_aliases:
                target = callee.attr
        elif isinstance(callee, ast.Name) and \
                callee.id in mod.kernel_func_aliases:
            target = callee.id
        if target is None:
            return None
        return self.wrapper_specs().get(target, KernelSpec())


def iter_assignments(node: ast.AST) -> Iterator[
        Tuple[List[str], ast.AST, int]]:
    """Yield ``(target_names, value_expr, lineno)`` for every simple
    assignment in ``node`` (tuple unpacking flattened; attribute and
    subscript targets reported by their dotted name when available)."""
    for sub in ast.walk(node):
        value: Optional[ast.AST] = None
        targets: List[ast.AST] = []
        if isinstance(sub, ast.Assign):
            value, targets = sub.value, list(sub.targets)
        elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
            value, targets = sub.value, [sub.target]
        elif isinstance(sub, ast.AugAssign):
            value, targets = sub.value, [sub.target]
        elif isinstance(sub, ast.NamedExpr):
            value, targets = sub.value, [sub.target]
        if value is None:
            continue
        names: List[str] = []
        stack = list(targets)
        while stack:
            tgt = stack.pop()
            if isinstance(tgt, (ast.Tuple, ast.List)):
                stack.extend(tgt.elts)
            elif isinstance(tgt, ast.Starred):
                stack.append(tgt.value)
            else:
                dn = dotted_name(tgt)
                if dn is not None:
                    names.append(dn)
        if names:
            yield names, value, sub.lineno

