"""Connected components over the core-grid merge graph.

* ``UnionFind``             -- host path-compression union-find, used by the
                               GriT-DBSCAN-LDF variant (paper §5.2) where the
                               *order* of merge checks matters (low-density
                               first, skip same-set pairs).
* ``label_propagation``     -- device pointer-jumping min-label propagation:
                               the data-parallel equivalent of BFS/union-find
                               (log-depth, fixed shapes).
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
                      edge_valid: torch.Tensor, node_valid: torch.Tensor,
                      max_rounds: int = 0) -> torch.Tensor:
    """Min-label propagation + pointer jumping over an undirected edge list.

    Args:
      num_nodes_cap: static node capacity N.
      edges: [E, 2] integer endpoints (arbitrary values where invalid).
      edge_valid: [E] bool.
      node_valid: [N] bool -- labels of invalid nodes come out as N.

    Returns labels [N] int32: connected-component representative (min node
    index in component).  Converges in O(log N) rounds; the loop exits
    early on a fixpoint, which costs one host read per round.
    """
    N = num_nodes_cap
    dev = edges.device
    rounds = max_rounds or (int(np.ceil(np.log2(max(N, 2)))) + 2)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    u = torch.where(edge_valid, edges[:, 0].to(torch.int64), zero)
    v = torch.where(edge_valid, edges[:, 1].to(torch.int64), zero)

    labels = torch.arange(N, dtype=torch.int64, device=dev)
    for _ in range(rounds):
        lu, lv = labels[u], labels[v]
        m = torch.minimum(lu, lv)
        # invalid edges are routed to node 0 with that node's own label:
        # a neutral update
        new = labels.clone()
        new.scatter_reduce_(0, u, torch.where(edge_valid, m, lu), "amin",
                            include_self=True)
        new.scatter_reduce_(0, v, torch.where(edge_valid, m, lv), "amin",
                            include_self=True)
        # pointer jumping: label <- label[label]  (halves tree height)
        new = new[new]
        new = new[new]
        changed = host_read((new != labels).any())
        labels = new
        if not changed:
            break
    labels = torch.where(node_valid, labels, torch.full_like(labels, N))
    return labels.to(torch.int32)
