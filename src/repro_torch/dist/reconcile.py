"""Cross-shard label reconciliation.

After every shard clusters its own + ghost points locally, cluster
identity must be stitched across slab boundaries.  The mechanism is the
paper's Theorem 4 plus the halo-width argument: any merge edge between
grids in adjacent slabs is witnessed by a core point within eps of the
boundary -- which is a *shared* point, clustered independently by both
shards.  Each shared core point therefore yields one edge
``(home shard label, remote shard label)`` between the two per-shard
label spaces; the per-shard edge lists are gathered in shard order and
one pointer-jumping pass maps every ``(shard, local label)`` pair to
its global component (on every rank, when the shards are ranks).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.labels import label_propagation
from .comm import LoopComm


def shared_point_edges(own_labels: torch.Tensor, own_core: torch.Tensor,
                       local_idx: torch.Tensor, remote_labels: torch.Tensor,
                       me: int, remote_shard: int, label_space: int):
    """Edges between my label space and a neighbor's, one per shared
    core point.

    Args:
      own_labels / own_core: my shard-local labels and core flags.
      local_idx: [H] my row of each shipped halo point (-1 padding).
      remote_labels: [H] the label my shipped point received at the
        neighbor (-1 where it was not a labeled core there), aligned
        with ``local_idx``.
      me / remote_shard: shard indices.
      label_space: per-shard label capacity L; global node id of
        (shard s, label l) is ``s * L + l``.

    Returns ``(edges [H, 2] int32 (-1 padding), valid [H] bool)``.  An
    edge requires the shared point to be a labeled core on *both*
    sides: border labels are order-dependent and must never stitch
    components together.
    """
    ok = (local_idx >= 0) & (remote_labels >= 0)
    safe = local_idx.clamp_min(0).to(torch.int64)
    mine = own_labels[safe].to(torch.int32)
    ok = ok & (mine >= 0) & own_core[safe]
    a = me * label_space + mine
    b = remote_shard * label_space + remote_labels.to(torch.int32)
    edges = torch.where(ok[:, None], torch.stack([a, b], dim=1),
                        torch.full((), -1, dtype=torch.int32,
                                   device=a.device))
    return edges, ok


def global_component_map(edges: Sequence[torch.Tensor],
                         edge_valid: Sequence[torch.Tensor], n_shards: int,
                         label_space: int, comm=None) -> torch.Tensor:
    """Concatenate the per-shard edge lists in shard order and
    pointer-jump them into one map ``(shard * L + local label) -> global
    component`` ([n_shards * L] int32).

    ``edges`` / ``edge_valid`` hold the lists of the shards this process
    holds; ``comm`` (``dist/comm.py``) gathers every shard's: in one
    process on the first list's device (the default), or across the
    ranks of a process group, where every rank builds the same map."""
    if comm is None:
        comm = LoopComm([e.device for e in edges])
    all_edges = comm.shard_concat(list(edges)).reshape(-1, 2)
    all_ok = comm.shard_concat(list(edge_valid)).reshape(-1)
    n_nodes = n_shards * label_space
    node_valid = torch.ones((n_nodes,), dtype=torch.bool,
                            device=all_edges.device)
    return label_propagation(n_nodes, all_edges.clamp_min(0), all_ok,
                             node_valid)
