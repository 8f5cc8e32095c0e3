"""Connected components over the core-grid merge graph.

* ``UnionFind``             -- host path-compression union-find, used by the
                               GriT-DBSCAN-LDF variant (paper §5.2) where the
                               *order* of merge checks matters (low-density
                               first, skip same-set pairs).
* ``label_propagation``     -- device hooking and pointer jumping: the
                               data-parallel equivalent of BFS/union-find
                               (fixed shapes, run to the fixpoint).
"""

from __future__ import annotations

import numpy as np
import torch

from .sync import host_read


class UnionFind:
    """Array-based union-find with path compression + union by size."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:            # path compression
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return True

    def labels(self) -> np.ndarray:
        return np.array([self.find(i) for i in range(len(self.parent))])


def label_propagation(num_nodes_cap: int, edges: torch.Tensor,
                      edge_valid: torch.Tensor, node_valid: torch.Tensor
                      ) -> torch.Tensor:
    """Connected components by hooking and pointer jumping over an
    undirected edge list.

    Args:
      num_nodes_cap: static node capacity N.
      edges: [E, 2] integer endpoints (arbitrary values where invalid).
      edge_valid: [E] bool.
      node_valid: [N] bool -- labels of invalid nodes come out as N.

    Returns labels [N] int32: connected-component representative (min node
    index in component).  Each round hooks the root of every edge's
    larger endpoint under the smaller root (``amin`` over the edges, so
    every hook points to a smaller index and the root of a tree is its
    least node), then jumps pointers until every node points at its
    root.  It runs to the fixpoint, whatever the graph: propagating
    labels one hop a round would need rounds in the order of the
    graph's diameter (a path in shuffled order: 1,567 rounds at 4,096
    nodes).  One host read a jump and a round.
    """
    N = num_nodes_cap
    dev = edges.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # invalid edges are routed to node 0 on both ends: a neutral hook
    u = torch.where(edge_valid, edges[:, 0].to(torch.int64), zero)
    v = torch.where(edge_valid, edges[:, 1].to(torch.int64), zero)

    labels = torch.arange(N, dtype=torch.int64, device=dev)
    while True:
        lu, lv = labels[u], labels[v]
        new = labels.clone()
        new.scatter_reduce_(0, torch.maximum(lu, lv), torch.minimum(lu, lv),
                            "amin", include_self=True)
        while True:
            jumped = new[new]
            if not host_read((jumped != new).any()):
                break
            new = jumped
        if not host_read((new != labels).any()):
            break
        labels = new
    labels = torch.where(node_valid, labels, torch.full_like(labels, N))
    return labels.to(torch.int32)
