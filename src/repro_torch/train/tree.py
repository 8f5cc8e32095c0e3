"""Nested dict / tuple trees of tensors, in the reference's leaf order.

The training state is a tree: dicts, tuples (lists alike) and tensor (or
scalar) leaves.  ``flatten`` lists the leaves in the order
``jax.tree_util.tree_flatten`` lists the reference's: dict keys sorted,
tuples in order, ``None`` dropped (an empty dict has no leaf).  That
order is what a checkpoint's ``arrays/<i>.npy`` index means, so a
checkpoint written by either package restores into the other's template.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = object()          # a leaf's place in a structure

# The walks are module-level functions with the accumulator passed in: a
# nested function that calls itself is a reference cycle (function ->
# closure cell -> function) that would hold the leaves it collected until
# the cyclic collector runs, so a dropped tree's tensors stayed allocated.


def _flatten_into(t, leaves: List[Any]):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _flatten_into(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (tuple, list)):
        return type(t)(_flatten_into(v, leaves) for v in t)
    leaves.append(t)
    return _LEAF


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure): the structure is the tree with every leaf
    replaced by a marker and every dict's keys sorted."""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(s, it):
    if s is _LEAF:
        return next(it)
    if s is None:
        return None
    if isinstance(s, dict):
        return {k: _build(v, it) for k, v in s.items()}
    return type(s)(_build(v, it) for v in s)


def unflatten(structure, leaves) -> Any:
    """The inverse of :func:`flatten`."""
    it = iter(leaves)
    out = _build(structure, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def _up_to(s, t, out: List[Any]) -> None:
    if s is _LEAF:
        out.append(t)
    elif isinstance(s, dict):
        for k, v in s.items():
            _up_to(v, t[k], out)
    elif s is not None:
        for v, u in zip(s, t):
            _up_to(v, u, out)


def flatten_up_to(structure, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``structure``, in leaf
    order (adafactor's per-leaf slot dicts; ``flatten_up_to`` of a
    ``PyTreeDef``)."""
    out: List[Any] = []
    _up_to(structure, tree, out)
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same places of ``rest``."""
    leaves, structure = flatten(tree)
    others = [flatten_up_to(structure, r) for r in rest]
    return unflatten(structure, [fn(*xs) for xs in zip(leaves, *others)])


def describe(structure) -> str:
    """A readable rendering of a structure (the checkpoint manifest's
    ``treedef``; restore reads only the leaf count)."""
    if structure is _LEAF:
        return "*"
    if structure is None:
        return "None"
    if isinstance(structure, dict):
        return "{" + ", ".join(f"'{k}': {describe(v)}"
                               for k, v in structure.items()) + "}"
    inner = ", ".join(describe(v) for v in structure)
    return f"({inner}{',' if len(structure) == 1 else ''})"
