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


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, structure): the structure is the tree with every leaf
    replaced by a marker and every dict's keys sorted."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def unflatten(structure, leaves) -> Any:
    """The inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(s):
        if s is _LEAF:
            return next(it)
        if s is None:
            return None
        if isinstance(s, dict):
            return {k: build(v) for k, v in s.items()}
        return type(s)(build(v) for v in s)

    out = build(structure)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the structure holds")
    return out


def flatten_up_to(structure, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaves of ``structure``, in leaf
    order (adafactor's per-leaf slot dicts; ``flatten_up_to`` of a
    ``PyTreeDef``)."""
    out: List[Any] = []

    def walk(s, t):
        if s is _LEAF:
            out.append(t)
        elif isinstance(s, dict):
            for k, v in s.items():
                walk(v, t[k])
        elif s is not None:
            for v, u in zip(s, t):
                walk(v, u)

    walk(structure, tree)
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
