"""Grid tree (paper §4.2): index over non-empty grids + neighbor queries.

The paper's grid tree is a (d+1)-level trie over the lexicographically
sorted identifiers of the non-empty grids, queried level-by-level while
pruning subtrees whose accumulated *offset*

    offset = sum_j max(|key_j - g_ij| - 1, 0)^2        (integer, side^2 units)

reaches ``d`` (at which point the minimum grid distance already exceeds
eps).  Neighbors are returned sorted by offset (closest grids first).

Array adaptation: the pointer trie becomes *level arrays* -- each level
is the sorted array of identifier prefixes, child sets are contiguous
ranges, and the paper's hash-table shortcut becomes (vectorized) binary
search.  Offset pruning and offset-sorted output are preserved verbatim.

Three query engines with identical results:

* ``GridTree.query``          -- host, fully vectorized over all queries.
* ``stencil_neighbors``       -- host baseline: gan/appr-DBSCAN style
                                 candidate-stencil enumeration (what the
                                 grid tree is designed to beat).
* ``device_neighbor_table``   -- torch version (static caps) used inside
                                 the device pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .sync import count_read, host_read


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def pack_rows(ids: np.ndarray) -> np.ndarray:
    """Pack non-negative int rows into byte strings whose lexicographic
    (bytewise) order equals numeric lexicographic row order."""
    ids = np.ascontiguousarray(ids.astype(">u4"))
    return ids.view(f"S{4 * ids.shape[1]}").ravel()


def radius(d: int) -> int:
    """Per-dimension search radius ceil(sqrt(d)) (paper §4.2.2)."""
    return int(math.ceil(math.sqrt(d)))


# --------------------------------------------------------------------------
# host grid tree
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GridTree:
    """Trie-as-arrays over lex-sorted grid identifiers (host index)."""

    ids: np.ndarray                       # [G, d] lex-sorted identifiers
    # per level j (0-based, key = ids[:, j]):
    level_starts: list                    # level j -> [n_j] row where prefix begins
    level_ends: list                      # level j -> [n_j] row past prefix end
    child_lo: list                        # level j -> [n_j] first child in level j+1
    child_hi: list                        # level j -> [n_j] past-last child

    @property
    def d(self) -> int:
        return int(self.ids.shape[1])

    @property
    def num_grids(self) -> int:
        return int(self.ids.shape[0])

    # -- Algorithm 2 (vectorized build) ------------------------------------
    @classmethod
    def build(cls, ids: np.ndarray) -> "GridTree":
        ids = np.asarray(ids, dtype=np.int64)
        G, d = ids.shape
        level_starts, level_ends = [], []
        for j in range(d):
            # new length-(j+1) prefix whenever any of the first j+1 cols change
            if G == 0:
                level_starts.append(np.zeros(0, np.int64))
                level_ends.append(np.zeros(0, np.int64))
                continue
            new = np.ones(G, dtype=bool)
            new[1:] = np.any(ids[1:, : j + 1] != ids[:-1, : j + 1], axis=1)
            s = np.flatnonzero(new)
            level_starts.append(s)
            level_ends.append(np.append(s[1:], G))
        child_lo, child_hi = [], []
        for j in range(d - 1):
            # children of level-j node = level-(j+1) nodes within its row range
            child_lo.append(np.searchsorted(level_starts[j + 1], level_starts[j], "left"))
            child_hi.append(np.searchsorted(level_starts[j + 1], level_ends[j], "left"))
        return cls(ids=ids, level_starts=level_starts, level_ends=level_ends,
                   child_lo=child_lo, child_hi=child_hi)

    # -- Algorithm 3 (batched over queries) --------------------------------
    def query(self, queries: np.ndarray, include_self: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Non-empty neighboring grids for each query identifier.

        Returns CSR ``(indptr[nq+1], nbr_grid[idx], nbr_offset[idx])`` with
        neighbors of each query sorted by offset ascending (paper line 16).
        ``nbr_offset`` is the integer squared grid distance in side^2 units.

        Queries need not be identifiers *of* the tree: the serving path
        (``GritIndex.predict``) queries with the cells of arbitrary new
        points, including empty cells and cells outside the fitted
        range (negative components are fine -- the per-level searches
        are value-based against the stored keys, which are >= 0).
        ``include_self=False`` drops only the *exact* identifier match;
        distinct grids at grid-distance 0 (adjacent cells, offset 0)
        are kept.
        """
        queries = np.asarray(queries, dtype=np.int64)
        nq, d = queries.shape
        assert d == self.d
        r = radius(d)
        G = self.num_grids

        # frontier: (query row, node position in level-j arrays, offset)
        q_idx = np.arange(nq, dtype=np.int64)
        # level 0 expansion: nodes are all level-0 entries; restrict by key
        node = None
        for j in range(d):
            keys = self.ids[self.level_starts[j], j]
            if j == 0:
                # root children: full level-0 node array, globally key-sorted
                lo = np.searchsorted(keys, queries[:, 0] - r, "left")
                hi = np.searchsorted(keys, queries[:, 0] + r, "right")
                cnt = hi - lo
                total = int(cnt.sum())
                base = np.repeat(np.cumsum(cnt) - cnt, cnt)
                node = (np.arange(total) - base) + np.repeat(lo, cnt)
                q_of = np.repeat(q_idx, cnt)
                delta = np.abs(keys[node] - queries[q_of, 0])
                off = np.maximum(delta - 1, 0) ** 2
            else:
                # children of frontier nodes: contiguous ranges in level j,
                # keys sorted within each range -> packed searchsorted
                clo = self.child_lo[j - 1][node]
                chi = self.child_hi[j - 1][node]
                # pack (child's parent position, key) so a single global
                # searchsorted respects per-parent ranges
                parent_of_level = np.repeat(
                    np.arange(len(self.level_starts[j - 1])),
                    self.child_hi[j - 1] - self.child_lo[j - 1])
                K = int(keys.max(initial=0)) + 2
                packed = parent_of_level * K + keys
                want = queries[q_of, j]
                lo = np.searchsorted(packed, node * K + np.maximum(want - r, 0), "left")
                hi = np.searchsorted(packed, node * K + (want + r), "right")
                lo = np.maximum(lo, clo)
                hi = np.minimum(hi, chi)
                cnt = np.maximum(hi - lo, 0)
                total = int(cnt.sum())
                base = np.repeat(np.cumsum(cnt) - cnt, cnt)
                child = (np.arange(total) - base) + np.repeat(lo, cnt)
                q_of = np.repeat(q_of, cnt)
                delta = np.abs(keys[child] - queries[q_of, j])
                off = np.repeat(off, cnt) + np.maximum(delta - 1, 0) ** 2
                node = child
            # offset pruning (Algorithm 3 line 9): drop subtrees at >= d
            keep = off < d
            node, q_of, off = node[keep], q_of[keep], off[keep]

        # leaf level: node positions are rows of `ids`
        grid = self.level_starts[d - 1][node] if d > 1 else self.level_starts[0][node]
        # NOTE: at j == d-1 each node is a unique full identifier -> one grid
        if not include_self:
            # offset 0 also matches *distinct* grids at grid-distance 0
            # (adjacent cells); only drop the exact self match.
            self_match = np.all(self.ids[grid] == queries[q_of], axis=1)
            grid, q_of, off = (grid[~self_match], q_of[~self_match],
                               off[~self_match])

        # sort per query by offset ascending (paper: counting sort)
        perm = np.lexsort((grid, off, q_of))
        grid, q_of, off = grid[perm], q_of[perm], off[perm]
        indptr = np.zeros(nq + 1, dtype=np.int64)
        np.add.at(indptr, q_of + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, grid, off


# --------------------------------------------------------------------------
# stencil baseline (gan-DBSCAN / appr-DBSCAN neighbor enumeration)
# --------------------------------------------------------------------------

_STENCILS: dict = {}


def offset_stencil(d: int) -> Tuple[np.ndarray, np.ndarray]:
    """All identifier deltas with offset < d (the exponential stencil)."""
    if d in _STENCILS:
        return _STENCILS[d]
    r = radius(d)
    rng = np.arange(-r, r + 1)
    grids = np.meshgrid(*([rng] * d), indexing="ij")
    deltas = np.stack([g.ravel() for g in grids], axis=1)
    off = (np.maximum(np.abs(deltas) - 1, 0) ** 2).sum(axis=1)
    keep = off < d
    deltas, off = deltas[keep], off[keep]
    order = np.argsort(off, kind="stable")
    _STENCILS[d] = (deltas[order], off[order])
    return _STENCILS[d]


def stencil_neighbors(ids: np.ndarray, queries: np.ndarray,
                      include_self: bool = True,
                      chunk: int = 256) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Baseline neighbor query: enumerate the full (2r+1)^d candidate
    stencil per grid and membership-test against the non-empty set.

    Same CSR output contract as ``GridTree.query``.  Cost is
    Theta(|stencil| * nq * log G) -- the exponential-in-d behaviour the
    grid tree avoids (paper §4.2, Fig. 11 analogue).
    """
    ids = np.asarray(ids, np.int64)
    queries = np.asarray(queries, np.int64)
    nq, d = queries.shape
    deltas, doff = offset_stencil(d)
    packed = pack_rows(ids)               # lex-sorted already
    out_q, out_g, out_o = [], [], []
    for s in range(0, nq, chunk):
        q = queries[s:s + chunk]
        cand = q[:, None, :] + deltas[None, :, :]          # [c, S, d]
        valid = (cand >= 0).all(-1)
        flat = cand.reshape(-1, d)
        flat = np.maximum(flat, 0)
        pos = np.searchsorted(packed, pack_rows(flat))
        pos = np.minimum(pos, len(packed) - 1)
        hit = (packed[pos] == pack_rows(flat)) & valid.reshape(-1)
        qq = np.repeat(np.arange(len(q)) + s, len(deltas))[hit]
        gg = pos[hit]
        oo = np.tile(doff, len(q))[hit]
        if not include_self:
            keep = ~np.all(ids[gg] == queries[qq], axis=1)
            qq, gg, oo = qq[keep], gg[keep], oo[keep]
        out_q.append(qq); out_g.append(gg); out_o.append(oo)
    q_of = np.concatenate(out_q); grid = np.concatenate(out_g); off = np.concatenate(out_o)
    perm = np.lexsort((grid, off, q_of))
    q_of, grid, off = q_of[perm], grid[perm], off[perm]
    indptr = np.zeros(nq + 1, dtype=np.int64)
    np.add.at(indptr, q_of + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, grid, off


# --------------------------------------------------------------------------
# device grid tree: level arrays and a ragged descent
# --------------------------------------------------------------------------

#: entries of one level of a descent per chunk of query rows: memory
#: chunking, not semantics (every query row is independent)
ROW_CHUNK_ELEMS = 1 << 23


@dataclasses.dataclass
class DeviceLevels:
    """The grid tree's level arrays over ``G`` distinct lex-sorted rows
    of non-negative identifiers, on their device.  Level ``j`` holds its
    nodes (the distinct ``j+1``-prefixes) in order, each as the packed
    key ``parent * base[j] + key`` (``parent``: the node's prefix at
    level ``j-1``, 0 at level 0), so one ``searchsorted`` finds the
    children of a node within a key range; ``base[j]`` exceeds every key
    of column ``j`` by more than ``radius(d)``.  ``leaf_row`` maps the
    last level's nodes to rows (:func:`level_arrays` builds them)."""

    packed: list
    base: list
    leaf_row: torch.Tensor


def level_arrays(rows: torch.Tensor) -> DeviceLevels:
    """The :class:`DeviceLevels` of ``G`` distinct lex-sorted rows
    ``[G, d]`` of non-negative identifiers: one host read, and one a
    level."""
    G, d = rows.shape
    dev = rows.device
    r = radius(d)
    top = host_read(rows.amax(0)) if G else [0] * d
    base = [int(t) + r + 1 for t in top]
    packed = []
    parent_of_row = torch.zeros(G, dtype=torch.int64, device=dev)
    first = torch.arange(G, device=dev)
    for j in range(d):
        new = torch.ones(G, dtype=torch.bool, device=dev)
        if G > 1:
            new[1:] = (rows[1:, :j + 1] != rows[:-1, :j + 1]).any(1)
        first = torch.nonzero(new)[:, 0]
        count_read()
        packed.append(parent_of_row[first] * base[j] + rows[first, j])
        parent_of_row = torch.cumsum(new.to(torch.int64), 0) - 1
    return DeviceLevels(packed=packed, base=base, leaf_row=first)


def descend(levels: DeviceLevels, q: torch.Tensor,
            frontier_cap: Optional[int] = None):
    """Algorithm 3 for the query rows ``q`` [Q, d] (int64 identifiers of
    rows of the tree, or any cells of its range), written out as a
    ragged descent: each level expands every kept prefix to its children
    within ``radius(d)`` on the next axis (one ``searchsorted`` over the
    level's packed keys), prunes at offset >= d, and orders each query's
    survivors by offset, stably, so the order within an offset is the
    order of the expansion -- the order the reference's fixed-width
    frontier keeps.  With ``frontier_cap`` a query keeps its first
    ``frontier_cap`` survivors of a level.  The work is the surviving
    entries, not the ``(2r+1)^d`` stencil.

    Returns ``(q_of, grid, off, widest, over, entries)``: the leaves, by
    query and then offset ascending -- query index into ``q``, tree row,
    integer offset --; per query the most survivors of any level
    ``[Q]``; per query whether a level had more than ``frontier_cap``
    ``[Q]`` bool; and the entries expanded over all levels (a host
    int).  Two host reads a level."""
    Q, d = q.shape
    dev = q.device
    r = radius(d)
    q_of = torch.arange(Q, device=dev)
    node = torch.zeros(Q, dtype=torch.int64, device=dev)
    off = torch.zeros(Q, dtype=torch.int64, device=dev)
    widest = torch.zeros(Q, dtype=torch.int64, device=dev)
    over = torch.zeros(Q, dtype=torch.bool, device=dev)
    entries = 0
    for j in range(d):
        keys, b = levels.packed[j], levels.base[j]
        want = q[q_of, j]
        lo = node * b + torch.clamp_min(want - r, 0)
        a = torch.searchsorted(keys, lo)
        cnt = torch.searchsorted(keys, node * b + want + r, right=True) - a
        total = int(host_read(cnt.sum()))
        entries += total
        src = torch.repeat_interleave(
            torch.arange(cnt.shape[0], device=dev), cnt, output_size=total)
        child = a[src] + torch.arange(total, device=dev) \
            - (torch.cumsum(cnt, 0) - cnt)[src]
        key = keys[child] - node[src] * b
        q_of, node = q_of[src], child
        off = off[src] + torch.clamp_min(torch.abs(key - want[src]) - 1,
                                         0) ** 2
        alive = off < d
        # each query's survivors first, offset ascending, stable
        order = torch.sort(q_of * (d + 1) + torch.where(alive, off, d),
                           stable=True).indices
        q_of, node, off, alive = (q_of[order], node[order], off[order],
                                  alive[order])
        n_alive = torch.zeros(Q, dtype=torch.int64, device=dev).index_add_(
            0, q_of, alive.to(torch.int64))
        widest = torch.maximum(widest, n_alive)
        keep = alive
        if frontier_cap is not None:
            over |= n_alive > frontier_cap
            per_q = torch.bincount(q_of, minlength=Q)
            rank = torch.arange(q_of.shape[0], device=dev) \
                - (torch.cumsum(per_q, 0) - per_q)[q_of]
            keep = alive & (rank < frontier_cap)
        idx = torch.nonzero(keep)[:, 0]
        count_read()
        q_of, node, off = q_of[idx], node[idx], off[idx]
    return q_of, levels.leaf_row[node], off, widest, over, entries


def descend_rows(levels: DeviceLevels, rows: torch.Tensor,
                 frontier_cap: Optional[int] = None):
    """:func:`descend` for every row of ``rows``, in chunks of rows sized
    from ``ROW_CHUNK_ELEMS`` entries a level and the entries a row the
    chunks before needed: yields ``(start, end, descend(...))``."""
    n, d = rows.shape
    s, per_row = 0, min((2 * radius(d) + 1) ** d, max(n, 1))
    while s < n:
        e = min(s + max(64, ROW_CHUNK_ELEMS // max(1, min(per_row, n))), n)
        out = descend(levels, rows[s:e], frontier_cap)
        yield s, e, out
        per_row = max(1, 2 * out[-1] // (d * (e - s)))
        s = e


def device_neighbor_table(sorted_ids: torch.Tensor, num_grids: torch.Tensor,
                          frontier_cap: int = 128, k_cap: int = 64,
                          include_self: bool = True):
    """Algorithm 3 for every non-empty grid simultaneously.

    Args:
      sorted_ids: [G_cap, d] lex-sorted identifiers (PAD_ID padded).
      num_grids:  [] actual number of grids (tensor on the same device).
      frontier_cap: static cap on per-level surviving prefix ranges.
      k_cap: static cap on returned neighbors per grid.

    The descent (:func:`descend`) visits the live-grid prefix (the lex
    sort parks every live grid in rows [0, num_grids)); dead rows are
    ``-1``.  The reference's ``packed`` choice has no twin here: both of
    its routes give this table.

    The live rows are queried in chunks sized from a memory budget
    (``ROW_CHUNK_ELEMS`` entries a level); results are per-row
    independent, so the chunk size is not part of the semantics.  A
    truncated frontier keeps the same survivors, and raises the same
    flag, as the fixed-width frontier of the reference.

    Returns:
      nbr:     [G_cap, k_cap] int32 neighbor grid rows (-1 padded),
               offset-ascending per row (paper's sorted order).
      nbr_off: [G_cap, k_cap] int32 integer offsets (side^2 units).
      ovf_frontier: [] bool -- frontier_cap exceeded (result a subset).
      ovf_k:        [] bool -- k_cap exceeded (result a subset).
    """
    G_cap, d = sorted_ids.shape
    dev = sorted_ids.device
    n_rows = min(int(host_read(num_grids)), G_cap)
    rows = sorted_ids[:n_rows].to(torch.int64)
    levels = level_arrays(rows) if n_rows else None

    nbr = torch.full((G_cap, k_cap), -1, dtype=torch.int32, device=dev)
    nbr_off = torch.full((G_cap, k_cap), -1, dtype=torch.int32, device=dev)
    ovf_f = torch.zeros((), dtype=torch.bool, device=dev)
    ovf_k = torch.zeros((), dtype=torch.bool, device=dev)
    for s, e, (q_of, grid, off, _, over, _) in descend_rows(
            levels, rows, frontier_cap):
        if not include_self:
            other = torch.nonzero(grid != q_of + s)[:, 0]
            count_read()
            q_of, grid, off = q_of[other], grid[other], off[other]
        count = torch.bincount(q_of, minlength=e - s)
        rank = torch.arange(q_of.shape[0], device=dev) \
            - (torch.cumsum(count, 0) - count)[q_of]
        fit = torch.nonzero(rank < k_cap)[:, 0]
        count_read()
        flat = (q_of[fit] + s) * k_cap + rank[fit]
        nbr.view(-1)[flat] = grid[fit].to(torch.int32)
        nbr_off.view(-1)[flat] = off[fit].to(torch.int32)
        ovf_f = ovf_f | over.any()
        ovf_k = ovf_k | (count > k_cap).any()
    return nbr, nbr_off, ovf_f, ovf_k
