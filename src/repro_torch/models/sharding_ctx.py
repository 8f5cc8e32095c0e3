"""Activation-sharding context.

The model code is mesh-agnostic: it calls ``constrain(x, tag)`` at the
few points where the reference nudges GSPMD (residual stream, embedding
output, logits, MoE expert buffers and compute weights).  A launcher
installs a tag -> sharding mapping (``launch.sharding.activation_specs``:
each value has a ``mesh`` and a ``spec``); on one device and in the
tests the mapping is empty and ``constrain`` is the identity.

``constrain`` redistributes only a ``DTensor``: the mesh paths of the
port compute on local tensors (gathered weights, the rank's batch rows;
see ``DESIGN_TORCH.md``), where the tags have nothing to move.

``set_shardmap_moe((mesh, batch_axes, model_axis))`` routes
``moe_forward`` to the explicit-collective MoE variants.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

_SPECS: Dict[str, object] = {}
_SHARDMAP_MOE = None      # (mesh, batch_axes tuple, model_axis name) | None


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
