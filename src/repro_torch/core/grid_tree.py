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
from typing import Tuple

import numpy as np
import torch

from .sync import host_read


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
# device neighbor table
# --------------------------------------------------------------------------

def _bsearch(col: torch.Tensor, value: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, steps: int) -> torch.Tensor:
    """Left binary search for ``value`` in sorted ``col[lo:hi]``
    (vectorized, fixed trip count)."""
    top = col.shape[0] - 1
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        pred = col[torch.clamp(mid, 0, top)] < value
        active = lo < hi
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


# elements of one [rows, frontier * (2r+2)] search array per row chunk
ROW_CHUNK_ELEMS = 1 << 23


def _query_rows(sorted_ids: torch.Tensor, rows: torch.Tensor,
                num_grids: torch.Tensor, frontier_cap: int, k_cap: int,
                include_self: bool):
    """Algorithm 3 for the grid rows ``rows`` [R], written out with a
    leading row dimension.  Returns (nbr [R, k_cap], nbr_off [R, k_cap],
    ovf_frontier [R] bool, ovf_k [R] bool)."""
    G_cap, d = sorted_ids.shape
    dev = sorted_ids.device
    r = radius(d)
    steps = int(math.ceil(math.log2(max(G_cap, 2)))) + 1
    n_k = 2 * r + 1
    BIG = 2 ** 30
    R = rows.shape[0]

    q = sorted_ids[rows].to(torch.int64)                    # [R, d]
    lo = torch.zeros((R, 1), dtype=torch.int64, device=dev)
    hi = num_grids.to(torch.int64).expand(R, 1)
    off = torch.zeros((R, 1), dtype=torch.int64, device=dev)
    valid = torch.ones((R, 1), dtype=torch.bool, device=dev)
    ovf_frontier = torch.zeros((R,), dtype=torch.bool, device=dev)
    span = torch.arange(-r, r + 2, device=dev)              # [n_k + 1]

    for j in range(d):
        # the traversal starts from ONE root range and multiplies by at
        # most n_k per level, so level j holds <= n_k^j live ranges:
        # the level's arrays are that wide, not a flat frontier_cap
        W = lo.shape[1]
        col = sorted_ids[:, j].to(torch.int64)
        # one left search over the n_k+1 consecutive keys
        # [q_j-r .. q_j+r+1]; keys are consecutive integers, so
        # right(k) == left(k+1) and the range ends come for free
        ks1 = q[:, j, None] + span[None, :]                 # [R, n_k+1]
        shape = (R, W, n_k + 1)
        pos = _bsearch(col, ks1[:, None, :].expand(shape),
                       lo[:, :, None].expand(shape),
                       hi[:, :, None].expand(shape), steps)
        nlo = pos[:, :, :-1].reshape(R, W * n_k)
        nhi = pos[:, :, 1:].reshape(R, W * n_k)
        off_e = off[:, :, None].expand(R, W, n_k).reshape(R, W * n_k)
        val_e = valid[:, :, None].expand(R, W, n_k).reshape(R, W * n_k)
        k_e = ks1[:, None, :-1].expand(R, W, n_k).reshape(R, W * n_k)
        doff = torch.clamp_min(torch.abs(k_e - q[:, j, None]) - 1, 0) ** 2
        noff = off_e + doff
        nval = val_e & (nlo < nhi) & (noff < d) & (k_e >= 0)
        # compact: valid entries first, offset ascending within valid
        key = torch.where(nval, noff, torch.full_like(noff, BIG))
        order = torch.argsort(key, dim=1, stable=True)
        take = order[:, :min(W * n_k, frontier_cap)]
        ovf_frontier = ovf_frontier | (nval.sum(dim=1) > frontier_cap)
        lo, hi = torch.gather(nlo, 1, take), torch.gather(nhi, 1, take)
        off, valid = torch.gather(noff, 1, take), torch.gather(nval, 1, take)

    # leaves: each surviving range is a single grid row (full id fixed)
    if k_cap > lo.shape[1]:
        # leaf arrays are level-d wide; widen so the promised
        # [., k_cap] output shape holds
        ext = k_cap - lo.shape[1]
        lo = torch.cat([lo, lo.new_zeros((R, ext))], dim=1)
        off = torch.cat([off, off.new_full((R, ext), BIG)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((R, ext))], dim=1)
    grid = torch.where(valid, lo, torch.full_like(lo, -1))
    if not include_self:
        valid = valid & ~(valid & (lo == rows[:, None]))
        grid = torch.where(valid, grid, torch.full_like(grid, -1))
        off = torch.where(valid, off, torch.full_like(off, BIG))
        order = torch.argsort(off, dim=1, stable=True)
        grid = torch.gather(grid, 1, order)
        off = torch.gather(off, 1, order)
        valid = torch.gather(valid, 1, order)
    ovf_k = valid.sum(dim=1) > k_cap
    off = torch.where(valid, off, torch.full_like(off, -1))
    return (grid[:, :k_cap].to(torch.int32), off[:, :k_cap].to(torch.int32),
            ovf_frontier, ovf_k)


def device_neighbor_table(sorted_ids: torch.Tensor, num_grids: torch.Tensor,
                          frontier_cap: int = 128, k_cap: int = 64,
                          include_self: bool = True, packed: bool = True):
    """Algorithm 3 for every non-empty grid simultaneously.

    Args:
      sorted_ids: [G_cap, d] lex-sorted identifiers (PAD_ID padded).
      num_grids:  [] actual number of grids (tensor on the same device).
      frontier_cap: static cap on per-level surviving prefix ranges.
      k_cap: static cap on returned neighbors per grid.
      packed: sweep only the live-grid prefix (the lex sort parks every
        live grid in rows [0, num_grids)); costs one host read of
        ``num_grids``.  The dense path traverses every ``G_cap`` row and
        masks the dead ones.  Identical results: live rows run the same
        per-row query either way, dead rows are ``-1`` in both.

    Rows are swept in chunks sized from a memory budget
    (``ROW_CHUNK_ELEMS``); results are per-row independent, so the chunk
    size is not part of the semantics.

    Returns:
      nbr:     [G_cap, k_cap] int32 neighbor grid rows (-1 padded),
               offset-ascending per row (paper's sorted order).
      nbr_off: [G_cap, k_cap] int32 integer offsets (side^2 units).
      ovf_frontier: [] bool -- frontier_cap exceeded (result a subset).
      ovf_k:        [] bool -- k_cap exceeded (result a subset).
    """
    G_cap, d = sorted_ids.shape
    dev = sorted_ids.device
    n_k = 2 * radius(d) + 1
    width = min(n_k ** max(d - 1, 0), frontier_cap) * (n_k + 1)
    chunk = max(64, ROW_CHUNK_ELEMS // max(width, k_cap, 1))
    n_rows = min(int(host_read(num_grids)), G_cap) if packed else G_cap

    nbr = torch.full((G_cap, k_cap), -1, dtype=torch.int32, device=dev)
    nbr_off = torch.full((G_cap, k_cap), -1, dtype=torch.int32, device=dev)
    ovf_f = torch.zeros((), dtype=torch.bool, device=dev)
    ovf_k = torch.zeros((), dtype=torch.bool, device=dev)
    for s in range(0, n_rows, chunk):
        rows = torch.arange(s, min(s + chunk, n_rows), device=dev)
        live = rows < num_grids
        g, o, of, ok = _query_rows(sorted_ids, rows, num_grids,
                                   frontier_cap, k_cap, include_self)
        neg = torch.full_like(g, -1)
        nbr[s:s + rows.shape[0]] = torch.where(live[:, None], g, neg)
        nbr_off[s:s + rows.shape[0]] = torch.where(live[:, None], o, neg)
        ovf_f = ovf_f | (of & live).any()
        ovf_k = ovf_k | (ok & live).any()
    return nbr, nbr_off, ovf_f, ovf_k
