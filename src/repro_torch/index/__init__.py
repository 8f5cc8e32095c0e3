"""index: the fitted ``GritIndex`` (fit once, serve point queries and
micro-batch inserts / deletes without refitting).

    from repro_torch.engine import cluster
    res = cluster(points, eps=3000.0, min_pts=10, return_index=True)
    labels = res.index.predict(new_points)       # exact, no refit
    res.index.insert(micro_batch)                # incremental splice
    res.index.delete(arrival_ids)                # exact removal
    res.index.ensure_device_state()              # resident serving state
    snap = res.index.snapshot()                  # flat arrays, savez-able
    reps = make_replicas(res.index, 2)           # read-only log replicas
    sidx = fit_sharded(points, 3000.0, 10, n_shards=4)   # slab shards

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"``.  Both mutation directions run through one delta
engine (``repro_torch.index.delta``) that maintains the persistent
core-grid merge graph.  :class:`ShardedGritIndex` keeps one ``GritIndex``
per dim-0 slab plus a global label map (the serving artifact of a
distributed fit).
"""

from .delta import (MutationLog, build_merge_graph, compact, delete_ids,
                    insert_batch)
from .grit_index import GritIndex, PredictCaps
from .replica import ReplicaIndex, make_replicas
from .sharded import LabelMap, ShardedGritIndex, fit_sharded

__all__ = ["GritIndex", "LabelMap", "MutationLog", "PredictCaps",
           "ReplicaIndex", "ShardedGritIndex", "build_merge_graph",
           "compact", "delete_ids", "fit_index", "fit_sharded",
           "insert_batch", "make_replicas"]


def fit_index(points, eps: float, min_pts: int, *, engine: str = "auto",
              device=None, **opts) -> GritIndex:
    """Fit-and-index in one call: ``cluster(..., return_index=True).index``."""
    from ..engine import cluster
    return cluster(points, eps, min_pts, engine=engine, device=device,
                   return_index=True, **opts).index
