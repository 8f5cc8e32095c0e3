"""``hot-path-sync``: the serving hot loop must not wait on the card.

The device-resident serving plane is fast because ``ClusterServer.step``
and the ``DeviceState`` dispatch stages enqueue device work and wait for
it at each stage's single intended block point.  One stray ``.item()``,
``.cpu()`` or blocking upload in that call graph makes the host wait for
the card and the card wait for the host -- and nothing crashes, so
nothing catches it.

This is a project-level rule: it builds a call graph (simple-name
matching, BFS) from the hot-path roots and flags, in every reachable
function, the operations after which PyTorch waits for the card:

* always: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` (unless
  its receiver is already such a copy), ``.to("cpu")``,
  ``torch.cuda.synchronize()``, ``Event`` / ``Stream.synchronize()``,
  ``torch.nonzero`` / ``.nonzero()``, ``torch.unique`` / ``.unique()``,
  ``masked_select``, and the port's counted reads ``sync.host_read`` /
  ``sync.count_read``;
* ``bool`` / ``int`` / ``float`` / ``np.asarray`` / ``np.array`` when
  the operand is device-derived: a ``*dev`` name, a ``*_res`` resident
  buffer, a tensor made with ``device=`` or moved by ``.to(<device>)`` /
  ``.cuda()``, or a value assigned from a kernel operator or from a
  function that returns one (to a fixpoint);
* blocking host-to-device copies: ``.to(<device>)`` and ``.cuda()`` of a
  value that is not device-derived, and ``torch.as_tensor`` /
  ``torch.tensor`` / ``torch.asarray(..., device=<device>)``, each
  without ``non_blocking=True`` -- PyTorch waits on the stream after a
  copy from pageable host memory.

The card, not this list, is the judge: the on-card smoke run replays the
serving stream under ``torch.cuda.set_sync_debug_mode("warn")`` and
fails on a runtime sync site that this rule does not report.  The
intended block points carry justified pragmas; syncs that are not
intended carry pragmas whose reason starts with ``KNOWN:``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..context import (FunctionUnit, ModuleInfo, ProjectContext,
                       dotted_name, iter_assignments, simple_callee)
from ..registry import Rule, register_rule
from ..report import Violation

#: dispatch stages in index/device_state.py that are hot-path roots
STAGE_ROOTS = frozenset({
    "predict_device_async", "predict_device", "recompute_cores_device",
    "decide_edges_device", "border_pass_device",
})

#: modules that can never be on the serving hot path -- name collisions
#: with their functions must not drag them into the reachable set
_EXCLUDED_PARTS = frozenset({
    "train", "launch", "bench", "examples", "scripts", "tests",
    "analysis",
})

_MATERIALIZERS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "float", "int", "bool",
})
#: methods that copy to the host and wait for it
_ALWAYS_METHODS = frozenset({"item", "tolist", "cpu", "synchronize",
                             "nonzero", "unique", "masked_select"})
#: functions that wait for the card
_ALWAYS_FUNCS = frozenset({
    "torch.cuda.synchronize", "torch.nonzero", "torch.unique",
    "torch.masked_select", "sync.host_read", "sync.count_read",
    "host_read", "count_read",
})
_UPLOADERS = frozenset({"torch.as_tensor", "torch.tensor",
                        "torch.asarray"})


def _excluded(mod: ModuleInfo) -> bool:
    return bool(set(mod.path_parts()) & _EXCLUDED_PARTS)


def _is_root(mod: ModuleInfo, unit: FunctionUnit) -> bool:
    # roots are ClusterServer.step and the DeviceState *dispatch*
    # stages; audit helpers like DeviceState.mirror_matches are only
    # covered if some root actually reaches them
    if unit.qualname == "ClusterServer.step":
        return True
    return (mod.relpath.endswith("index/device_state.py")
            and unit.simple_name in STAGE_ROOTS)


def _is_device(node: ast.AST) -> bool:
    """True for an expression that names a CUDA device: ``"cuda..."``,
    ``torch.device(...)`` of one, or a ``dev`` / ``device`` name or
    attribute (``ds.device``, ``x.device``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, ast.Call) and \
            dotted_name(node.func) == "torch.device":
        return bool(node.args) and _is_device(node.args[0])
    dn = dotted_name(node)
    return dn is not None and dn.rsplit(".", 1)[-1] in ("dev", "device")


def _is_host(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and \
        dotted_name(node.func) == "torch.device" and \
        bool(node.args) and _is_host(node.args[0])


def _target(call: ast.Call) -> Optional[ast.AST]:
    """The device argument of a ``.to(...)`` call: its ``device=``
    keyword, else its first positional argument."""
    for kw in call.keywords:
        if kw.arg == "device":
            return kw.value
    return call.args[0] if call.args else None


def _non_blocking(call: ast.Call) -> bool:
    return any(kw.arg == "non_blocking" and
               isinstance(kw.value, ast.Constant) and kw.value.value is True
               for kw in call.keywords)


def _moves_to_device(call: ast.Call) -> bool:
    """``x.to(<device>)`` / ``x.cuda()`` / a factory given
    ``device=<device>``: a tensor that lives on the card."""
    if isinstance(call.func, ast.Attribute):
        if call.func.attr == "cuda":
            return True
        if call.func.attr == "to":
            tgt = _target(call)
            return tgt is not None and _is_device(tgt)
    dn = dotted_name(call.func)
    if dn is not None and dn.startswith("torch."):
        return any(kw.arg == "device" and _is_device(kw.value)
                   for kw in call.keywords)
    return False


def _copies_to_host(call: ast.Call) -> bool:
    """``x.cpu()`` / ``x.to("cpu")`` (through ``.detach()``)."""
    if not isinstance(call.func, ast.Attribute):
        return False
    if call.func.attr == "cpu":
        return True
    if call.func.attr == "to":
        tgt = _target(call)
        return tgt is not None and _is_host(tgt)
    if call.func.attr == "detach" and \
            isinstance(call.func.value, ast.Call):
        return _copies_to_host(call.func.value)
    return False


def _device_producers(ctx: ProjectContext) -> Set[str]:
    """Simple names of functions whose return value lives on the card:
    kernel operators and the ``kernels/ops.py`` wrappers, plus (to
    fixpoint) functions returning a device expression or the result of
    another producer."""
    producers: Set[str] = set()
    for mod in ctx.modules:
        for unit in mod.units:
            if unit.kernel is not None or \
                    mod.relpath.endswith("kernels/ops.py"):
                producers.add(unit.simple_name)
    for _ in range(4):
        grew = False
        for mod in ctx.modules:
            for unit in mod.units:
                if unit.simple_name in producers:
                    continue
                for node in ast.walk(unit.node):
                    if isinstance(node, ast.Return) and \
                            node.value is not None and \
                            _device_expr(node.value, producers, set()):
                        producers.add(unit.simple_name)
                        grew = True
                        break
        if not grew:
            break
    return producers


def _device_expr(expr: ast.AST, producers: Set[str],
                 tainted: Set[str]) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name):
            if sub.id.endswith("dev") or sub.id.endswith("_res") or \
                    sub.id in tainted:
                return True
        elif isinstance(sub, ast.Attribute):
            if sub.attr.endswith("_res"):
                return True
        if isinstance(sub, ast.Call):
            if _moves_to_device(sub):
                return True
            dn = dotted_name(sub.func)
            if dn is not None and dn.startswith("torch.ops."):
                return True
            if simple_callee(sub) in producers:
                return True
    return False


def _device_tainted_names(unit: FunctionUnit,
                          producers: Set[str]) -> Set[str]:
    tainted: Set[str] = set()
    for names, value, _line in sorted(
            iter_assignments(unit.node), key=lambda t: t[2]):
        if _device_expr(value, producers, tainted):
            tainted.update(n for n in names if "." not in n)
    return tainted


@register_rule
class HotPathSync(Rule):
    name = "hot-path-sync"
    description = ("host synchronization inside the call graph of "
                   "ClusterServer.step / DeviceState dispatch")

    def check_project(self, ctx: ProjectContext) -> List[Violation]:
        mod_of: Dict[int, ModuleInfo] = {}
        roots: List[FunctionUnit] = []
        for mod in ctx.modules:
            for unit in mod.units:
                mod_of[id(unit)] = mod
                if not _excluded(mod) and _is_root(mod, unit):
                    roots.append(unit)
        if not roots:
            return []

        reachable: Dict[int, FunctionUnit] = {}
        frontier = list(roots)
        while frontier:
            unit = frontier.pop()
            if id(unit) in reachable:
                continue
            reachable[id(unit)] = unit
            for name in unit.called_names:
                for callee in ctx.units_by_simple.get(name, []):
                    cmod = mod_of[id(callee)]
                    if not _excluded(cmod) and \
                            id(callee) not in reachable:
                        frontier.append(callee)

        producers = _device_producers(ctx)
        out: List[Violation] = []
        for unit in reachable.values():
            out.extend(self._check_unit(
                mod_of[id(unit)], unit, producers))
        return out

    def _check_unit(self, mod: ModuleInfo, unit: FunctionUnit,
                    producers: Set[str]) -> List[Violation]:
        tainted = _device_tainted_names(unit, producers)
        out: List[Violation] = []
        for node in ast.walk(unit.node):
            if not isinstance(node, ast.Call):
                continue
            v = self._check_call(mod, unit, node, producers, tainted)
            if v is not None:
                out.append(v)
        return out

    def _check_call(self, mod: ModuleInfo, unit: FunctionUnit,
                    node: ast.Call, producers: Set[str],
                    tainted: Set[str]) -> Optional[Violation]:
        where = (f"in {unit.qualname}() on the serving hot path; "
                 "route through the stage's intended block point or "
                 "pragma with the reason")
        dn = dotted_name(node.func)
        if dn in _ALWAYS_FUNCS:
            return self._v(mod, node, f"{dn}() waits for the card {where}")
        if isinstance(node.func, ast.Attribute) and \
                not (dn or "").startswith(("np.", "numpy.")):
            attr = node.func.attr
            if attr in _ALWAYS_METHODS and \
                    (attr != "item" or not node.args):
                return self._v(mod, node,
                               f".{attr}() waits for the card {where}")
            if attr == "numpy" and not (
                    isinstance(node.func.value, ast.Call)
                    and _copies_to_host(node.func.value)):
                return self._v(mod, node,
                               f".numpy() host copy {where}")
            if _copies_to_host(node) and attr == "to":
                return self._v(mod, node,
                               f".to('cpu') host copy {where}")
            if attr in ("to", "cuda") and _moves_to_device(node) and \
                    not _non_blocking(node) and not _device_expr(
                        node.func.value, producers, tainted):
                return self._v(
                    mod, node,
                    f".{attr}() blocking host-to-device copy {where}")
        if dn in _UPLOADERS and _moves_to_device(node) and \
                not _non_blocking(node) and node.args and \
                not _device_expr(node.args[0], producers, tainted):
            return self._v(mod, node,
                           f"{dn}(device=...) blocking host-to-device "
                           f"copy {where}")
        if dn in _MATERIALIZERS and node.args:
            if _device_expr(node.args[0], producers, tainted):
                return self._v(
                    mod, node,
                    f"{dn}() materializes a device value {where}")
        return None

    def _v(self, mod: ModuleInfo, node: ast.Call,
           message: str) -> Violation:
        return Violation(rule=self.name, path=mod.path,
                         line=node.lineno, col=node.col_offset,
                         message=message)
