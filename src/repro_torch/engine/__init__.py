"""engine: the unified clustering API (registry + adaptive-cap loop).

    from repro_torch.engine import cluster
    result = cluster(points, eps=3000.0, min_pts=10)   # engine="auto"

Runs on the CUDA device; pass ``device="cpu"`` to run on the CPU.
"""

from .result import ClusterResult
from .registry import (available_engines, cluster, engine_descriptions,
                       get_engine, register_engine, resolve_auto)
from .adaptive import (CapOverflowError, adaptive_device_dbscan,
                       adaptive_loop, candidate_census, estimate_caps,
                       estimate_shard_caps, grow_caps, grid_stats,
                       resolve_device, stencil_neighbor_bound)

__all__ = [
    "ClusterResult", "cluster", "available_engines", "engine_descriptions",
    "get_engine", "register_engine", "resolve_auto",
    "CapOverflowError", "adaptive_device_dbscan", "adaptive_loop",
    "candidate_census", "estimate_caps", "estimate_shard_caps",
    "grow_caps", "grid_stats", "resolve_device", "stencil_neighbor_bound",
]
