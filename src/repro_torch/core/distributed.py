"""Compatibility shim: the distributed plane lives in ``repro_torch.dist``.

The package has one module per concern -- host slab sharding
(``repro_torch.dist.sharding``), halo compaction
(``repro_torch.dist.halo``), cross-shard label reconciliation
(``repro_torch.dist.reconcile``), the cluster step + caps
(``repro_torch.dist.step``) and the host-facing entry points
(``repro_torch.dist.api``).  Import from ``repro_torch.dist`` in new
code; this module keeps the historical names importable, as the
reference package does.  The reference's shim also re-exports its
jitted-step cache (``_STEP_CACHE`` / ``_cached_cluster_step``); the
eager step compiles nothing, so there is no cache to export.
"""

import warnings

from ..dist import (ClusterCaps, DistributedFitResult,  # noqa: F401
                    distributed_dbscan, distributed_fit, make_cluster_step,
                    shard_points_by_slab)

warnings.warn(
    "repro_torch.core.distributed is deprecated; import ClusterCaps, "
    "distributed_fit, distributed_dbscan, ... from repro_torch.dist (the "
    "distributed serving subsystem) instead.",
    DeprecationWarning,
    stacklevel=2,
)

__all__ = [
    "ClusterCaps", "DistributedFitResult", "distributed_dbscan",
    "distributed_fit", "make_cluster_step", "shard_points_by_slab",
]
