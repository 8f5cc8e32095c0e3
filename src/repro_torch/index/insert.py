"""Compatibility shim: the insert path moved into the unified mutation
plane ``repro_torch.index.delta``.

What used to live here as an insert-only splice is now one *delta
engine* shared by both mutation directions -- ``insert_batch`` and
``delete_ids`` run the same direction-parameterized stages (touched
stencil closure -> per-grid core recompute -> FastMerging re-decision
at changed-core-set grids -> component relabel over the persistent
merge graph -> border reconciliation).  Import from
``repro_torch.index.delta`` in new code; this module keeps the
historical name importable, as the reference package does.
"""

import warnings

from .delta import insert_batch  # noqa: F401

warnings.warn(
    "repro_torch.index.insert is deprecated; import insert_batch from "
    "repro_torch.index.delta (the unified mutation plane) instead.",
    DeprecationWarning,
    stacklevel=2,
)

__all__ = ["insert_batch"]
