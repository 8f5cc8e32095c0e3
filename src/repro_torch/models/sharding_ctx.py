"""Activation-sharding context.

The model code is mesh-agnostic: it calls ``constrain(x, tag)`` at the
few points where the reference nudges GSPMD (residual stream, embedding
output, logits, MoE expert buffers and compute weights).  A launcher
installs a tag -> sharding mapping (``launch.sharding.activation_specs``:
each value has a ``mesh`` and a ``spec``); on one device and in the
tests the mapping is empty and ``constrain`` is the identity.

``constrain`` redistributes only a ``DTensor``: the mesh paths of the
port compute on local tensors (the params' local view, the rank's batch
rows; see ``DESIGN_TORCH.md``), where the tags have nothing to move.

``set_shardmap_moe((mesh, batch_axes, model_axis))`` routes
``moe_forward`` to the explicit-collective MoE variants;
``set_tensor_parallel((mesh, model_axis))`` (or the context manager
``tensor_parallel``) splits the dense trunk's compute over the model axis
(``models/tensor_parallel.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

_SPECS: Dict[str, object] = {}
_SHARDMAP_MOE = None      # (mesh, batch_axes tuple, model_axis name) | None
_TENSOR_PARALLEL = None   # (mesh, model_axis name) | None


def set_policy(specs: Optional[Dict[str, object]]) -> None:
    global _SPECS
    _SPECS = dict(specs or {})


def set_shardmap_moe(ctx) -> None:
    """Enable the explicit-collective MoE path: ctx = (mesh, batch_axes,
    model_axis) or None to disable."""
    global _SHARDMAP_MOE
    _SHARDMAP_MOE = ctx


def get_shardmap_moe():
    return _SHARDMAP_MOE


def set_tensor_parallel(ctx) -> None:
    """Split the compute over the model axis: ctx = (mesh, model_axis),
    or None to compute on whole weights."""
    global _TENSOR_PARALLEL
    _TENSOR_PARALLEL = ctx


def get_tensor_parallel():
    return _TENSOR_PARALLEL


@contextlib.contextmanager
def tensor_parallel(ctx):
    """``set_tensor_parallel(ctx)`` for the block, the previous context
    after it."""
    old = get_tensor_parallel()
    set_tensor_parallel(ctx)
    try:
        yield
    finally:
        set_tensor_parallel(old)


def get_policy() -> Dict[str, object]:
    return dict(_SPECS)


@contextlib.contextmanager
def policy(specs: Optional[Dict[str, object]]):
    old = get_policy()
    set_policy(specs)
    try:
        yield
    finally:
        set_policy(old)


def constrain(x, tag: str):
    sh = _SPECS.get(tag)
    if sh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from ..launch.sharding import placements
    return x.redistribute(sh.mesh, placements(sh.mesh, sh.spec))
