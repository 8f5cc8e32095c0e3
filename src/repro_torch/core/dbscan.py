"""GriT-DBSCAN (paper Algorithm 6) and baselines — host engines.

Pipeline (paper §4.4):
  1. partition into grids (Alg 1) + grid tree (Alg 2) + neighbor queries (Alg 3)
  2. identify core points G13-style (all-core shortcut for grids with
     >= MinPts points; offset-sorted candidate scan with early exit otherwise)
  3. merge core grids into clusters via FastMerging (Alg 5)
       - variant "grit": BFS over seeds exactly as Algorithm 6
       - variant "ldf":  union-find + low-density-first order (paper §5.2)
  4. assign non-core points as border/noise

Label contract: ``labels[i] >= 0`` cluster id, ``-1`` noise.  Cluster ids
are arbitrary but consistent; use ``canonicalize_labels`` to compare.

``brute_dbscan`` is the O(n^2) oracle used by tests and benchmarks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from .grids import build_grids, GridIndex
from .grid_tree import GridTree, stencil_neighbors
from .merging import fast_merging, center_prune_merge, brute_min_dist
from .labels import UnionFind


# --------------------------------------------------------------------------
# oracle
# --------------------------------------------------------------------------

def brute_dbscan(points: np.ndarray, eps: float, min_pts: int,
                 chunk: int = 2048) -> np.ndarray:
    """Reference DBSCAN: O(n^2) neighborhood counts + BFS over core graph."""
    pts = np.asarray(points, np.float64)
    n = len(pts)
    eps2 = float(eps) ** 2
    counts = np.zeros(n, dtype=np.int64)
    for s in range(0, n, chunk):
        d2 = ((pts[s:s + chunk, None, :] - pts[None, :, :]) ** 2).sum(-1)
        counts[s:s + chunk] = (d2 <= eps2).sum(1)
    core = counts >= min_pts
    labels = np.full(n, -1, dtype=np.int64)
    cid = 0
    core_idx = np.flatnonzero(core)
    for seed in core_idx:
        if labels[seed] != -1:
            continue
        labels[seed] = cid
        frontier = [seed]
        while frontier:
            b = pts[frontier]
            d2 = ((b[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
            reach = np.flatnonzero((d2 <= eps2).any(0))
            nxt = []
            for r in reach:
                if labels[r] == -1:
                    labels[r] = cid
                    if core[r]:
                        nxt.append(r)
            frontier = nxt
        cid += 1
    return labels


def canonicalize_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel clusters by first occurrence so label arrays are comparable."""
    labels = np.asarray(labels)
    out = np.full_like(labels, -1)
    mapping: dict = {}
    nxt = 0
    for i, l in enumerate(labels):
        if l < 0:
            continue
        if l not in mapping:
            mapping[l] = nxt
            nxt += 1
        out[i] = mapping[l]
    return out


# --------------------------------------------------------------------------
# GriT-DBSCAN host engine
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DBSCANResult:
    labels: np.ndarray           # [n] cluster per point (-1 noise)
    core: np.ndarray             # [n] bool
    stats: dict                  # timings + counters
    grid: Optional[GridIndex] = None   # the partition the run was built on


def _neighbor_lists(gi: GridIndex, engine: str):
    """CSR neighbor lists for all grids (self excluded), offset-sorted."""
    if engine == "tree":
        tree = GridTree.build(gi.ids)
        return tree.query(gi.ids, include_self=False)
    elif engine == "stencil":
        return stencil_neighbors(gi.ids, gi.ids, include_self=False)
    raise ValueError(engine)


def _identify_cores(points: np.ndarray, gi: GridIndex, indptr, nbr,
                    eps: float, min_pts: int, stats: dict) -> np.ndarray:
    """Step 2: core flags per point (original order)."""
    pts = np.asarray(points, np.float64)
    eps2 = eps * eps
    n = len(pts)
    core = np.zeros(n, dtype=bool)
    big = gi.counts >= min_pts
    # all-core shortcut
    for g in np.flatnonzero(big):
        core[gi.order[gi.starts[g]:gi.starts[g] + gi.counts[g]]] = True
    stats["all_core_grids"] = int(big.sum())
    # small grids: offset-sorted candidate scan with early exit
    dist_evals = 0
    for g in np.flatnonzero(~big):
        own = gi.order[gi.starts[g]:gi.starts[g] + gi.counts[g]]
        p = pts[own]
        cnt = np.full(len(own), len(own), dtype=np.int64)  # own grid all <= eps
        nbrs = nbr[indptr[g]:indptr[g + 1]]
        undecided = cnt < min_pts
        for ng in nbrs:                       # offset-ascending (paper order)
            if not undecided.any():
                break
            cand = gi.order[gi.starts[ng]:gi.starts[ng] + gi.counts[ng]]
            d2 = ((p[undecided][:, None, :] - pts[cand][None, :, :]) ** 2).sum(-1)
            dist_evals += d2.size
            cnt[undecided] += (d2 <= eps2).sum(1)
            undecided = cnt < min_pts
        core[own] = cnt >= min_pts
    stats["core_dist_evals"] = dist_evals
    return core


def _core_sets(gi: GridIndex, core: np.ndarray):
    """Per-grid arrays of core-point indices (original order ids)."""
    sets = []
    for g in range(gi.num_grids):
        own = gi.order[gi.starts[g]:gi.starts[g] + gi.counts[g]]
        sets.append(own[core[own]])
    return sets


def _assign_noncore(points, gi: GridIndex, indptr, nbr, core, grid_label,
                    eps, labels, stats):
    """Step 4: border vs noise for non-core points."""
    pts = np.asarray(points, np.float64)
    eps2 = eps * eps
    dist_evals = 0
    for g in range(gi.num_grids):
        own = gi.order[gi.starts[g]:gi.starts[g] + gi.counts[g]]
        nc = own[~core[own]]
        if len(nc) == 0:
            continue
        p = pts[nc]
        best = np.full(len(nc), np.inf)
        blab = np.full(len(nc), -1, dtype=np.int64)
        cand_grids = [g] + list(nbr[indptr[g]:indptr[g + 1]])
        for ng in cand_grids:
            cand = gi.order[gi.starts[ng]:gi.starts[ng] + gi.counts[ng]]
            cand = cand[core[cand]]
            if len(cand) == 0:
                continue
            d2 = ((p[:, None, :] - pts[cand][None, :, :]) ** 2).sum(-1)
            dist_evals += d2.size
            j = d2.argmin(1)
            m = d2[np.arange(len(nc)), j]
            upd = (m <= eps2) & (m < best)
            best[upd] = m[upd]
            blab[upd] = labels[cand[j[upd]]]
        labels[nc] = blab
    stats["border_dist_evals"] = dist_evals


def grit_dbscan(points: np.ndarray, eps: float, min_pts: int,
                variant: str = "grit", neighbor_engine: str = "tree",
                merge_engine: str = "fast",
                rng: Optional[np.random.Generator] = None) -> DBSCANResult:
    """GriT-DBSCAN / GriT-DBSCAN-LDF and ablation engines (host).

    variant: "grit" (Alg 6 BFS) | "ldf" (union-find, low-density first)
    neighbor_engine: "tree" (grid tree) | "stencil" (gan-style baseline)
    merge_engine: "fast" (Alg 5) | "center" (KNN-BLOCK baseline) | "brute"
    """
    pts = np.asarray(points, np.float64)
    n = len(pts)
    stats: dict = {"n": n, "variant": variant, "neighbor_engine": neighbor_engine,
                   "merge_engine": merge_engine}

    t0 = time.perf_counter()
    gi = build_grids(pts, eps)
    stats["num_grids"] = gi.num_grids
    t1 = time.perf_counter()
    indptr, nbr, nbr_off = _neighbor_lists(gi, neighbor_engine)
    t2 = time.perf_counter()
    core = _identify_cores(pts, gi, indptr, nbr, eps, min_pts, stats)
    t3 = time.perf_counter()

    core_sets = _core_sets(gi, core)
    is_core_grid = np.array([len(s) > 0 for s in core_sets])
    merge_stats: dict = {}
    if merge_engine == "fast":
        merge = lambda a, b: fast_merging(a, b, eps, rng=rng, stats=merge_stats)
    elif merge_engine == "center":
        merge = lambda a, b: center_prune_merge(a, b, eps, stats=merge_stats)
    elif merge_engine == "brute":
        def merge(a, b):
            merge_stats["dist_evals"] = merge_stats.get("dist_evals", 0) + len(a) * len(b)
            merge_stats["calls"] = merge_stats.get("calls", 0) + 1
            return brute_min_dist(a, b) <= eps
    else:
        raise ValueError(merge_engine)

    grid_label = np.full(gi.num_grids, -1, dtype=np.int64)
    merge_checks = 0
    if variant == "grit":
        # Algorithm 6: BFS over seeds
        cid = 0
        for g0 in range(gi.num_grids):
            if not is_core_grid[g0] or grid_label[g0] != -1:
                continue
            grid_label[g0] = cid
            seeds = [g0]
            pos = 0
            while pos < len(seeds):
                cur = seeds[pos]
                pos += 1
                for g2 in nbr[indptr[cur]:indptr[cur + 1]]:
                    if not is_core_grid[g2] or grid_label[g2] != -1:
                        continue
                    merge_checks += 1
                    if merge(pts[core_sets[cur]], pts[core_sets[g2]]):
                        grid_label[g2] = cid
                        seeds.append(g2)
            cid += 1
    elif variant == "ldf":
        # union-find + low-density-first traversal (paper §5.2)
        uf = UnionFind(gi.num_grids)
        m = np.array([len(s) for s in core_sets])
        order = np.argsort(m, kind="stable")          # ascending core count
        for g in order:
            if not is_core_grid[g]:
                continue
            for g2 in nbr[indptr[g]:indptr[g + 1]]:
                if not is_core_grid[g2]:
                    continue
                if uf.find(g) == uf.find(g2):
                    continue                          # already same cluster
                merge_checks += 1
                if merge(pts[core_sets[g]], pts[core_sets[g2]]):
                    uf.union(g, g2)
        roots = {}
        for g in np.flatnonzero(is_core_grid):
            r = uf.find(g)
            if r not in roots:
                roots[r] = len(roots)
            grid_label[g] = roots[r]
    else:
        raise ValueError(variant)
    t4 = time.perf_counter()
    stats["merge_checks"] = merge_checks
    stats.update({f"merge_{k}": v for k, v in merge_stats.items()})

    labels = np.full(n, -1, dtype=np.int64)
    for g in range(gi.num_grids):
        if grid_label[g] < 0:
            continue
        own = gi.order[gi.starts[g]:gi.starts[g] + gi.counts[g]]
        labels[own[core[own]]] = grid_label[g]
    _assign_noncore(pts, gi, indptr, nbr, core, grid_label, eps, labels, stats)
    t5 = time.perf_counter()

    stats["t_partition"] = t1 - t0
    stats["t_neighbors"] = t2 - t1
    stats["t_cores"] = t3 - t2
    stats["t_merge"] = t4 - t3
    stats["t_assign"] = t5 - t4
    stats["t_total"] = t5 - t0
    stats["num_clusters"] = int(grid_label.max() + 1) if (grid_label >= 0).any() else 0
    return DBSCANResult(labels=labels, core=core, stats=stats, grid=gi)
