"""dist: the distributed plane (slab sharding + halo exchange + the
per-shard cluster step + label reconciliation), one module per concern:

* :mod:`repro_torch.dist.sharding`  -- host-side slab partition:
  grid-line cuts along dim 0, vectorized shard packing/unpacking, halo
  bound.
* :mod:`repro_torch.dist.halo`      -- halo compaction (the fixed-cap
  buffers exchanged between neighbor shards) and its host census.
* :mod:`repro_torch.dist.rebalance` -- load-triggered topology policy:
  EWMA per-shard load, bounded split-hottest / merge-coldest actuation
  on a :class:`repro_torch.index.ShardedGritIndex`.
* :mod:`repro_torch.dist.reconcile` -- cross-shard label
  reconciliation: edge construction over shared core points + the
  global component map.
* :mod:`repro_torch.dist.step`      -- ``ClusterCaps`` and the cluster
  step, a loop over the shards with one device each (repeats allowed);
  the shard-local pipeline is the full ``device_dbscan``, including the
  CUDA kernel plane when ``caps.grit.use_kernels`` is set.
* :mod:`repro_torch.dist.api`       -- the host-facing entry points:
  :func:`distributed_fit` (labels + core flags + grid provenance; feeds
  :class:`repro_torch.index.ShardedGritIndex`) and the legacy
  :func:`distributed_dbscan` (labels, report).

See DESIGN.md §5 for the sharding strategy and exactness argument.
"""

from .sharding import (halo_bound, owner_of_slab, shard_points_by_slab,
                       slab_cuts)
from .halo import boundary_census, census_halo_cap, halo_buffer
from .rebalance import RebalancePolicy, Rebalancer
from .step import ClusterCaps, make_cluster_step, make_staged_cluster_steps
from .api import (DistributedFitResult, distributed_dbscan, distributed_fit,
                  shard_devices)

__all__ = [
    "ClusterCaps", "DistributedFitResult", "RebalancePolicy", "Rebalancer",
    "boundary_census", "census_halo_cap", "distributed_dbscan",
    "distributed_fit", "halo_bound", "halo_buffer", "make_cluster_step",
    "make_staged_cluster_steps", "owner_of_slab", "shard_devices",
    "shard_points_by_slab", "slab_cuts",
]
