"""Adaptive-cap loop for the static-shape device pipeline.

The device GriT pipeline (``device_dbscan``) trades the paper's dynamic
data structures for static caps; every cap carries an overflow flag.

1. :func:`estimate_caps` derives an initial ``GritCaps`` from *grid
   statistics* computed where its input lives (torch operations on the
   device of a tensor, on the port's device for a numpy array) -- one
   sort of the grid keys and one ``searchsorted`` of the stencil probes:
   the non-empty-grid count bounds ``grid_cap``, the max grid occupancy
   bounds ``m_cap`` (core points per grid can never exceed occupancy),
   the small grids' stencil occupancy sums bound ``c_cap``, and the
   stencil bound (3^d - 1, clamped to the exact offset-stencil size)
   seeds ``k_cap``.  Three integers come back to the host.  Where
   probing the stencil of every small grid would exceed
   ``PROBE_BUDGET`` (at d = 7 the stencil has 197,067 offsets), the
   census walks the grid tree instead, and the most neighbours and the
   widest level it meets size ``k_cap`` and ``frontier_cap``.
2. :func:`adaptive_device_dbscan` runs the pipeline, reads the per-cap
   :class:`OverflowReport` (one host read per attempt), geometrically
   grows exactly the caps that overflowed, and retries.  Caps are
   quantized to powers of two / block multiples, the same values as
   ``repro.engine.adaptive`` produces.

Growth is geometric (default 2x), so reaching a true bound B from an
under-estimate costs O(log B) attempts worst case; each cap is also
clamped at its provable maximum (e.g. candidates <= n, neighbors <= the
exact stencil size), so the loop terminates even on adversarial data.

The statistics work on integer grid identifiers.  Where the
identifier rows fit a mixed-radix int64 key they are compared as such
keys (``_row_keys``) rather than as structured rows: the same
memberships and counts, found much faster at 10^6 points.  Where they
do not, the estimate takes the host functions :func:`grid_stats` /
:func:`candidate_census`, which the distributed estimate also uses.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.device_dbscan import (GritCaps, DeviceDBSCANResult,
                                  OverflowReport, device_dbscan)
from ..core.grids import identifiers
from ..core.grid_tree import (GridTree, descend_rows, level_arrays,
                               offset_stencil, radius)
from ..core.sync import count_read, host_read


class CapOverflowError(RuntimeError):
    """Raised when the adaptive loop exhausts its retries."""

    def __init__(self, attempts: List[dict]):
        self.attempts = attempts
        last = attempts[-1]
        super().__init__(
            f"static caps still overflowing after {len(attempts)} "
            f"attempt(s): {last['overflow']}; last caps {last['caps']}")


def _pow2_at_least(x: int, lo: int = 1) -> int:
    return max(lo, 1 << max(int(x) - 1, 0).bit_length())


def _mult8(x: int) -> int:
    return max(8, (int(x) + 7) // 8 * 8)


@dataclasses.dataclass
class ResidentCaps:
    """Static shapes of a :class:`~repro_torch.index.GritIndex`'s
    device-resident serving state (``index.device_state``).

    Same cap discipline as :class:`GritCaps` / ``PredictCaps``:
    power-of-two quantization, so mutation-driven growth re-allocates
    the resident tensors at O(log n) distinct sizes, monotone growth
    (``grown_to``), and never silent truncation -- the host packs the
    resident buffers, so an overflow triggers a rebuild *before* any
    kernel runs.
    """

    row_cap: int = 0       # physical point rows (tombstones included)
    grid_cap: int = 0      # non-empty grids
    edge_cap: int = 0      # persistent merge-graph edges

    @classmethod
    def for_state(cls, rows: int, grids: int, edges: int
                  ) -> "ResidentCaps":
        return cls(row_cap=_pow2_at_least(rows, lo=256),
                   grid_cap=_pow2_at_least(grids, lo=64),
                   edge_cap=_pow2_at_least(edges, lo=64))

    def grown_to(self, other: "ResidentCaps"
                 ) -> Tuple["ResidentCaps", bool]:
        new = ResidentCaps(row_cap=max(self.row_cap, other.row_cap),
                           grid_cap=max(self.grid_cap, other.grid_cap),
                           edge_cap=max(self.edge_cap, other.edge_cap))
        return new, new != self


def stencil_neighbor_bound(d: int) -> int:
    """Exact max number of neighboring non-empty grids: the size of the
    offset-< d stencil, minus the grid itself."""
    deltas, _ = offset_stencil(d)
    return int(len(deltas)) - 1


def _row_keys(rows: np.ndarray, pad: int, base: np.ndarray
              ) -> Optional[np.ndarray]:
    """Mixed-radix int64 key of integer rows whose components lie in
    ``[-pad, base_j - pad)``; order and equality of keys are those of
    the rows.  None when the key space exceeds int64."""
    if float(np.prod(base.astype(np.float64))) >= 2.0 ** 62:
        return None
    key = np.zeros(len(rows), np.int64)
    for j in range(rows.shape[1]):
        key = key * int(base[j]) + (rows[:, j] + pad)
    return key


def _unique_rows(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(ids, axis=0, return_counts=True)`` for non-negative
    integer rows, through int64 keys where they fit."""
    ids = np.asarray(ids, np.int64)
    keys = _row_keys(ids, 0, ids.max(axis=0) + 1)
    if keys is None:
        return np.unique(ids, axis=0, return_counts=True)
    _, first, counts = np.unique(keys, return_index=True, return_counts=True)
    return ids[first], counts


def grid_stats(points: np.ndarray, eps: float,
               point_valid: Optional[np.ndarray] = None
               ) -> Tuple[int, int]:
    """(non-empty grid count, max occupancy) over the *valid* points."""
    pts = np.asarray(points, np.float64)
    if point_valid is not None:
        pts = pts[np.asarray(point_valid, bool)]
    if len(pts) == 0:
        return 1, 1
    ids, _, _ = identifiers(pts, eps)
    _, counts = _unique_rows(ids)
    return int(len(counts)), int(counts.max())


def _lex_rows(a: np.ndarray) -> np.ndarray:
    """Rows of an int array as a lexicographically sortable structured
    view (for vectorized row membership via searchsorted)."""
    a = np.ascontiguousarray(np.asarray(a, np.int64))
    return a.view([("", a.dtype)] * a.shape[1]).ravel()


def candidate_census(points: np.ndarray, eps: float, min_pts: int,
                     point_valid: Optional[np.ndarray] = None) -> int:
    """Exact host-side upper bound on any *small* grid's candidate
    total: for every non-empty grid with occupancy < MinPts, the sum of
    occupancies over its offset stencil (a superset of the grid tree's
    exact MinDist <= eps neighbor set, so the device pipeline's
    per-grid totals can never exceed it).  All-core grids skip the
    candidate scan entirely, so they don't constrain ``c_cap``.

    Vectorized: one ``searchsorted`` over the lex-sorted grid ids per
    stencil offset -- O(|stencil| * G log G); where the small grids
    times the stencil exceed ``PROBE_BUDGET`` probes, the host grid
    tree's query of the small grids instead."""
    return _host_census(points, eps, min_pts, point_valid)[0]


def _host_census(points, eps: float, min_pts: int, point_valid=None
                 ) -> Tuple[int, int, int]:
    """(:func:`candidate_census`, the small grids, the stencil probes or
    the tree's neighbour entries it examined)."""
    pts = np.asarray(points, np.float64)
    if point_valid is not None:
        pts = pts[np.asarray(point_valid, bool)]
    if len(pts) == 0:
        return 1, 0, 0
    d = pts.shape[1]
    ids, _, _ = identifiers(pts, eps)
    uids, counts = _unique_rows(ids)
    small = counts < min_pts
    n_small = int(small.sum())
    if not n_small:
        return 1, 0, 0
    deltas, _ = offset_stencil(d)
    if n_small * len(deltas) > PROBE_BUDGET:
        # the grid tree's neighbour sets are the stencil's non-empty
        # grids (the same offset < d rule), found without probing it
        indptr, grid, _ = GridTree.build(uids).query(uids[small])
        totals = np.add.reduceat(counts[grid], indptr[:-1])
        return int(totals.max()), n_small, len(grid)
    r = radius(d)
    base = uids.max(axis=0) + 2 * r + 1
    keyed = _row_keys(uids, r, base) is not None
    to_keys = (lambda a: _row_keys(a, r, base)) if keyed else _lex_rows
    keys = to_keys(uids)                         # sorted (unique rows)
    totals = np.zeros(n_small, np.int64)
    for delta in np.asarray(deltas, np.int64):
        probe = to_keys(uids[small] + delta)
        pos = np.searchsorted(keys, probe)
        pos = np.minimum(pos, len(keys) - 1)
        hit = keys[pos] == probe
        totals += np.where(hit, counts[pos], 0)
    return int(totals.max()), n_small, n_small * len(deltas)


def _caps_from_stats(n: int, d: int, num_grids: int, max_occ: int,
                     cand_max: int, margin: float, extra_grids: int,
                     use_kernels: bool, max_nbrs: Optional[int] = None,
                     widest: Optional[int] = None) -> GritCaps:
    """``GritCaps`` from (grid count, max occupancy, max small-grid
    candidate total) -- the quantization/clamp discipline of the
    estimator -- and, where the census walked the grid tree, the most
    neighbours of a grid and its widest level."""
    grid_cap = _pow2_at_least(
        int(math.ceil(num_grids * margin)) + extra_grids, lo=8)
    grid_block = min(64, grid_cap)

    # 3^d - 1 stencil heuristic, clamped to the exact offset-stencil
    # size (the provable per-grid neighbor maximum); at low d the exact
    # bound is small enough to just provision outright.  A census that
    # walked the tree measured the most neighbours: that, with the
    # estimate's margin (the pipeline's float32 identifiers can move a
    # boundary point into another grid)
    bound = stencil_neighbor_bound(d)
    k_est = bound if bound <= 32 else max(3 ** d - 1, 8)
    if max_nbrs is not None:
        k_est = int(math.ceil(max_nbrs * margin))
    k_cap = _mult8(min(k_est, bound, max(grid_cap - 1, 1)))

    m_cap = _mult8(max_occ)
    # candidate list of a small grid: the census is the exact stencil
    # occupancy sum, an upper bound on what the device's (possibly
    # tighter) MinDist neighbor set can produce
    c_cap = _pow2_at_least(min(n, cand_max), lo=32)

    # deduped (g < g') merge pairs are bounded by G * k / 2; density
    # rarely reaches it, but a half-bound start avoids a retry on
    # blob-like data where most neighbor pairs are core-core
    pair_cap = _pow2_at_least(num_grids * k_cap // 2 + 8, lo=64)
    pair_block = min(256, pair_cap)

    # the per-level surviving prefix count depends on the id
    # distribution, not just geometry; the r^(d-1) fanout regularly
    # undershoots by one pow2 step on blob-like data, and a too-small
    # frontier costs a full overflow fit + retry on EVERY caps=None
    # call -- double it up front (a [frontier_cap] working set, so the
    # headroom is nearly free)
    r = 2 * radius(d) + 1
    frontier_cap = _pow2_at_least(
        2 * min(int(r ** max(d - 1, 1)), 256), lo=32)
    if widest is not None:
        frontier_cap = _pow2_at_least(int(math.ceil(widest * margin)), lo=32)

    # paper Theorem 3: FastMerging terminates within |s_i| + |s_j|
    # iterations; the batched loop stops once every pair is decided, so
    # a generous bound costs nothing
    merge_iters = 2 * m_cap + 4

    return GritCaps(grid_cap=grid_cap, frontier_cap=frontier_cap,
                    k_cap=k_cap, c_cap=c_cap, m_cap=m_cap,
                    pair_cap=pair_cap, grid_block=grid_block,
                    pair_block=pair_block, merge_iters=merge_iters,
                    use_kernels=use_kernels)


#: elements of one chunk of the census's probe matrix (int64: 32 MiB)
PROBE_CHUNK = 1 << 22
#: stencil probes (small grids x offsets) above which the census walks
#: the grid tree instead of probing the stencil: one chunk of them.
#: Within it the probes are the cheaper route: on 10^6 seed-spreader
#: points at eps 5,000 on an H100, 1.4 ms against the walk's 5.3 ms at
#: d = 3 and 9.6 ms at d = 5 (one launch a chunk against two host reads
#: a level)
PROBE_BUDGET = PROBE_CHUNK
#: key of the rows that count nowhere: above every key that fits
_NO_KEY = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class GridCensus:
    """The estimate's statistics of the valid points' grids: the grid
    count, the largest occupancy, the most candidates of a grid below
    MinPts (1 when there is none), the grids below MinPts, and the
    stencil probes or grid-tree entries the census examined.  Where the
    census walked the grid tree it also knows the most non-empty
    neighbours of a grid and the most prefixes a grid's query keeps at
    one level (``max_nbrs``, ``widest``)."""

    num_grids: int
    max_occ: int
    cand_max: int
    small: int = 0
    probes: int = 0
    max_nbrs: Optional[int] = None
    widest: Optional[int] = None


def device_identifiers(x: torch.Tensor, eps: float, valid: torch.Tensor
                       ) -> torch.Tensor:
    """Eq. (1) where ``x`` lives: the float64 identifiers of
    :func:`~repro_torch.core.grids.identifiers` over the valid rows, bit
    for bit (``floor((x - mins) / side)`` in float64, ``mins`` over the
    valid rows), and 0 on the invalid ones.

    ``side`` is a 0-d float64 tensor on ``x``'s device: divided by a CPU
    scalar, PyTorch's CUDA division multiplies by the reciprocal, whose
    product can differ from numpy's quotient in the last bit."""
    x = x.to(torch.float64)
    d = x.shape[1]
    side = torch.tensor(float(eps) / np.sqrt(d), dtype=torch.float64,
                        device=x.device)
    mins = torch.where(valid[:, None], x, math.inf).amin(0)
    return torch.where(valid[:, None], torch.floor((x - mins) / side), 0.0)


def _stencil_census(keys, small_keys, n_small, stride, d):
    """The most candidates of a small grid: its stencil's probes, each
    ``key + sum_j delta_j * stride_j``, their grids' occupancies the
    widths of their runs in the sorted ``keys`` (a 0-d tensor)."""
    dev = keys.device
    deltas, _ = offset_stencil(d)
    step = (torch.as_tensor(np.asarray(deltas, np.int64)).to(dev)
            * stride).sum(1)
    rows = max(1, PROBE_CHUNK // len(step))
    best = torch.zeros((), dtype=torch.int64, device=dev)
    for lo in range(0, n_small, rows):
        probe = small_keys[lo:min(lo + rows, n_small), None] + step
        width = (torch.searchsorted(keys, probe, right=True)
                 - torch.searchsorted(keys, probe))
        best = torch.maximum(best, width.sum(1).max())
    return best


def _tree_census(gkeys, occ, small, base, d):
    """The grid tree walked for every grid (``grid_tree.descend_rows``): a
    grid's candidates are the occupancies of its leaves, itself
    included.  Returns ``(cand_max, max_nbrs, widest)`` as 0-d tensors
    and the entries expanded (a host int)."""
    dev = gkeys.device
    rows = torch.stack([torch.div(gkeys, math.prod(base[j + 1:]),
                                  rounding_mode="floor") % base[j]
                        for j in range(d)], 1)
    levels = level_arrays(rows)
    cand = torch.zeros((), dtype=torch.int64, device=dev)
    nbrs = torch.zeros((), dtype=torch.int64, device=dev)
    widest = torch.zeros((), dtype=torch.int64, device=dev)
    entries = 0
    for s, e, (q_of, grid, _, wide, _, n) in descend_rows(levels, rows):
        entries += n
        total = torch.zeros(e - s, dtype=torch.int64, device=dev).index_add_(
            0, q_of, occ[grid])
        cand = torch.maximum(cand, torch.where(small[s:e], total, 0).max())
        nbrs = torch.maximum(nbrs, torch.bincount(q_of, minlength=e - s).max())
        widest = torch.maximum(widest, wide.max())
    return cand, nbrs - 1, widest, entries


def device_grid_census(x: torch.Tensor, eps: float, min_pts: int,
                       valid: Optional[torch.Tensor] = None
                       ) -> Optional[GridCensus]:
    """The statistics of :func:`grid_stats` and :func:`candidate_census`,
    computed with torch operations where ``x`` lives; None where the
    padded identifier rows do not fit an int64 key (the host functions
    then take over).

    The rows' keys are those of ``_row_keys`` with the census's padding,
    sorted once: a run of equal keys is a grid, its length the grid's
    occupancy.  A small grid's candidates are the occupancies of the
    non-empty grids at offset < d, its stencil.  Where the small grids
    times the stencil stay within ``PROBE_BUDGET``, each stencil offset
    is probed: a key is linear in the identifier, so a probe is ``key +
    sum_j delta_j * stride_j`` and its grid's occupancy the width of its
    run in the sorted keys (two ``searchsorted``).  Beyond it (the 7-D
    stencil has 197,067 offsets) the census walks the grid tree over
    the keys' rows for every grid, at the cost of the non-empty
    neighbours, and learns the most neighbours and the widest level on
    the way.  Invalid rows take a key above every probe.  The stencil
    costs three host reads, each a few integers; the walk two a level
    of each chunk of grids, and its level arrays one a level.
    """
    n, d = x.shape
    dev = x.device
    if n == 0:
        return GridCensus(1, 1, 1)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    ids = device_identifiers(x, eps, valid)
    head = host_read(torch.cat([valid.sum().to(torch.float64)[None],
                                ids.amax(0)]))
    if head[0] == 0:
        return GridCensus(1, 1, 1)
    r = radius(d)
    base = [int(t) + 2 * r + 1 for t in head[1:]]
    if math.prod(base) >= 1 << 62:
        return None
    stride = torch.tensor([math.prod(base[j + 1:]) for j in range(d)],
                          dtype=torch.int64, device=dev)
    keys = ((ids.to(torch.int64) + r) * stride).sum(1)
    keys = torch.sort(torch.where(valid, keys, _NO_KEY)).values

    pos = torch.arange(n, device=dev)
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = keys[1:] != keys[:-1]
    last &= keys != _NO_KEY                  # the last row of each grid
    occ = torch.where(last, pos + 1 - torch.searchsorted(keys, keys), 0)
    small = last & (occ < min_pts)
    num_grids, max_occ, n_small = host_read(
        torch.stack([last.sum(), occ.max(), small.sum()]))
    if n_small == 0:
        return GridCensus(num_grids, max_occ, 1)

    stencil = len(offset_stencil(d)[0])
    with obs.span("adaptive.census", small=n_small) as sp:
        if n_small * stencil <= PROBE_BUDGET:
            small_keys = torch.sort(torch.where(small, keys, _NO_KEY)).values
            cand_max = host_read(_stencil_census(keys, small_keys, n_small,
                                                 stride, d))
            census = GridCensus(num_grids, max_occ, cand_max, n_small,
                                n_small * stencil)
        else:
            at = torch.nonzero(last)[:, 0]
            count_read()
            cand, nbrs, widest, entries = _tree_census(
                keys[at], occ[at], small[at], base, d)
            cand_max, max_nbrs, widest = host_read(
                torch.stack([cand, nbrs, widest]))
            census = GridCensus(num_grids, max_occ, cand_max, n_small,
                                entries, max_nbrs, widest)
        sp.set(probes=census.probes,
               route="stencil" if census.max_nbrs is None else "tree")
    return census


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, counted as a host read."""
    count_read()
    return t.cpu().numpy()


def estimate_caps(points, eps: float, min_pts: int,
                  point_valid=None,
                  margin: float = 1.25,
                  extra_grids: int = 2,
                  use_kernels: bool = False) -> GritCaps:
    """Initial ``GritCaps`` from grid statistics (see module doc).

    The statistics are computed where ``points`` lives: a tensor on its
    own device, a numpy array on the port's CUDA device when there is
    one and on the CPU when there is none (:func:`device_grid_census`).
    Identifier rows too wide for an int64 key take the host functions.
    Counter ``adaptive.estimate_caps.device`` / ``.host`` and the span's
    ``where`` say which ran.

    ``extra_grids`` reserves slots for the sentinel grids that padding
    points (``point_valid == False`` -> PAD_COORD) occupy.
    ``use_kernels`` selects the kernelized distance plane; it rides on
    the caps and is preserved by ``grow_caps``.
    """
    host = None if isinstance(points, torch.Tensor) else np.asarray(points)
    n, d = (points if host is None else host).shape
    with obs.span("adaptive.estimate_caps", n=n, d=d) as sp:
        if host is None:
            x = points
        else:
            dev = (resolve_device(None) if torch.cuda.is_available()
                   else torch.device("cpu"))
            x = torch.as_tensor(host, dtype=torch.float32
                                if host.dtype == np.float32
                                else torch.float64).to(dev)
        valid = (None if point_valid is None else
                 torch.as_tensor(point_valid, dtype=torch.bool).to(x.device))
        census = device_grid_census(x, eps, min_pts, valid)
        if census is not None:
            where = str(x.device)
        else:
            where = "host"
            if host is None:
                host = _host_copy(x)
            if isinstance(point_valid, torch.Tensor):
                point_valid = _host_copy(point_valid)
            census = GridCensus(*grid_stats(host, eps, point_valid),
                                *_host_census(host, eps, min_pts,
                                              point_valid))
        sp.set(where=where)
        obs.counter("adaptive.estimate_caps."
                    + ("host" if where == "host" else "device")).inc()
        obs.gauge("adaptive.census.probes").set(census.probes)
        return _caps_from_stats(n, d, census.num_grids, census.max_occ,
                                census.cand_max, margin, extra_grids,
                                use_kernels, census.max_nbrs, census.widest)


def _shard_point_sets(points: np.ndarray, eps: float, n_shards: int):
    """The exact per-shard point set of a distributed fit: the shard's
    own slab plus the 2*eps boundary bands its neighbors ship as ghosts
    (the same selection predicate as ``repro_torch.dist.halo.halo_buffer``)."""
    from ..dist.sharding import slab_cuts
    pts = np.asarray(points, np.float64)
    order, cut_idx, _ = slab_cuts(pts, eps, n_shards)
    starts = np.concatenate([[0], cut_idx]).astype(np.int64)
    ends = np.concatenate([cut_idx, [len(pts)]]).astype(np.int64)
    spts = pts[order]

    def ship(s: int, side: str) -> np.ndarray:
        seg = spts[starts[s]:ends[s]]
        if not len(seg):
            return seg
        x0 = seg[:, 0]
        if side == "hi":
            return seg[x0 >= x0.max() - 2 * eps]
        return seg[x0 <= x0.min() + 2 * eps]

    for s in range(n_shards):
        parts = [spts[starts[s]:ends[s]]]
        if s > 0:
            parts.append(ship(s - 1, "hi"))
        if s < n_shards - 1:
            parts.append(ship(s + 1, "lo"))
        sub = np.concatenate(parts)
        if len(sub):
            yield sub


def estimate_shard_caps(points: np.ndarray, eps: float, min_pts: int,
                        n_shards: int, margin: float = 1.25,
                        extra_grids: int = 2,
                        use_kernels: bool = False) -> GritCaps:
    """Per-shard ``GritCaps`` for the distributed fit.

    Global grid statistics are a valid but wasteful bound for the
    shard-local pipelines: slab cuts land on grid lines, so the worst
    *shard's* grid count is roughly ``1 / n_shards`` of the global one.
    This runs :func:`grid_stats` / :func:`candidate_census` per shard
    over the exact per-shard point set (own slab + the neighbors' 2*eps
    ghost bands) and takes the max over shards -- one set of caps that
    every shard shares, sized to the worst shard instead of the
    union."""
    pts = np.asarray(points, np.float64)
    n, d = pts.shape
    if n_shards <= 1:
        return estimate_caps(pts, eps, min_pts, margin=margin,
                             extra_grids=extra_grids,
                             use_kernels=use_kernels)
    num_grids, max_occ, cand_max, n_max = 1, 1, 1, 1
    for sub in _shard_point_sets(pts, eps, n_shards):
        g, o = grid_stats(sub, eps)
        c = candidate_census(sub, eps, min_pts)
        num_grids, max_occ = max(num_grids, g), max(max_occ, o)
        cand_max, n_max = max(cand_max, c), max(n_max, len(sub))
    return _caps_from_stats(n_max, d, num_grids, max_occ, cand_max,
                            margin, extra_grids, use_kernels)


def grow_caps(caps: GritCaps, overflowed: Tuple[str, ...], *,
              n: int, d: int, growth: float = 2.0) -> GritCaps:
    """Grow exactly the caps named in ``overflowed`` (an
    ``OverflowReport.overflowing()`` tuple), geometrically, clamped at
    each cap's provable maximum."""
    assert overflowed, "grow_caps called without any overflow"
    kw = dataclasses.asdict(caps)
    g = lambda x: int(math.ceil(x * growth))

    if "grid" in overflowed:
        kw["grid_cap"] = _pow2_at_least(g(caps.grid_cap))
    if "frontier" in overflowed:
        kw["frontier_cap"] = _pow2_at_least(
            min(g(caps.frontier_cap), kw["grid_cap"]))
    if "neighbors" in overflowed:
        kw["k_cap"] = _mult8(min(g(caps.k_cap), stencil_neighbor_bound(d)))
    if "candidates" in overflowed:
        kw["c_cap"] = min(_pow2_at_least(g(caps.c_cap)),
                          _pow2_at_least(n))
    if "core_set" in overflowed:
        kw["m_cap"] = _mult8(min(g(caps.m_cap), n))
    if "pairs" in overflowed:
        kw["pair_cap"] = _pow2_at_least(
            min(g(caps.pair_cap), kw["grid_cap"] * kw["k_cap"]))

    kw["grid_block"] = min(64, kw["grid_cap"])
    kw["pair_block"] = min(256, kw["pair_cap"])
    kw["merge_iters"] = 2 * kw["m_cap"] + 4
    new = GritCaps(**kw)
    cap_of = {"grid": "grid_cap", "frontier": "frontier_cap",
              "neighbors": "k_cap", "candidates": "c_cap",
              "core_set": "m_cap", "pairs": "pair_cap"}
    grew = any(getattr(new, cap_of[f]) > getattr(caps, cap_of[f])
               for f in overflowed if f in cap_of)
    if not grew:
        # every overflowing cap is already at its clamp -- nothing left
        # to grow; surface that instead of looping forever (callers with
        # a retry history catch this and re-raise with the full trail)
        raise CapOverflowError(
            [{"caps": dataclasses.asdict(caps), "overflow": overflowed}])
    return new


def adaptive_loop(run, grow, describe, caps, max_retries: int):
    """The shared grow/retry protocol behind the adaptive runs.

    ``run(caps) -> (result, OverflowReport)`` executes one attempt;
    ``grow(caps, overflowed) -> caps`` grows exactly the named caps (may
    raise :class:`CapOverflowError` at a clamp); ``describe(caps)``
    renders caps for the attempt trail.  When ``grid`` overflows, the
    flags downstream of the grid table (frontier, neighbors, candidates,
    core_set, pairs) are dropped for that round: a truncated table
    funnels the excess points into the last grid, making them unreliable
    until the grids fit.  ``halo`` is measured from the raw points and
    stays trustworthy, so it keeps growing alongside ``grid``.

    Each attempt is a span ``adaptive.attempt`` (args ``index``,
    ``overflow``, ``kept``) that ends with the report's read, so it
    covers the attempt's device work with no added wait.

    Returns (result, attempts); raises :class:`CapOverflowError` with
    the full real attempt trail on exhaustion or clamp.
    """
    attempts: List[dict] = []
    for i in range(max_retries + 1):
        with obs.span("adaptive.attempt", index=i) as sp:
            result, report = run(caps)
            overflowed = report.overflowing()
            sp.set(overflow=list(overflowed), kept=not overflowed)
            # the report's read waited for the stream: the stage
            # events of the attempt have completed
            obs.resolve_device_times()
        attempts.append({"caps": describe(caps), "overflow": overflowed})
        obs.counter("adaptive.attempts").inc()
        if not overflowed:
            return result, attempts
        obs.counter("adaptive.retries").inc()
        for f in overflowed:
            obs.counter(f"adaptive.overflow.{f}").inc()
        if "grid" in overflowed:
            overflowed = tuple(f for f in overflowed
                               if f in ("grid", "halo"))
        try:
            caps = grow(caps, overflowed)
        except CapOverflowError:
            raise CapOverflowError(attempts) from None
    raise CapOverflowError(attempts)


def resolve_device(device=None) -> torch.device:
    """The device rule of the port: ``None`` means the CUDA device and
    raises when there is none; anything else is honoured as given (the
    tests ask for ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the GPU "
                "by default; pass device=\"cpu\" to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def adaptive_device_dbscan(points, eps: float, min_pts: int,
                           caps: Optional[GritCaps] = None, *,
                           point_valid=None, max_retries: int = 8,
                           growth: float = 2.0,
                           use_kernels: Optional[bool] = None,
                           device=None
                           ) -> Tuple[DeviceDBSCANResult, List[dict]]:
    """Run ``device_dbscan``, growing caps on overflow until exact.

    ``points`` is a numpy array or a tensor; a numpy array is placed on
    ``device`` (default: the CUDA device), a tensor stays where it is.
    ``use_kernels`` overrides the distance plane carried by ``caps``
    (None leaves the caps' own setting -- False for estimated caps --
    untouched); the flag survives every growth round unchanged.

    Returns (result, attempts); ``attempts`` records the caps and the
    overflowing-cap names of every try (the last entry has no overflow).
    Raises :class:`CapOverflowError` if ``max_retries`` growth rounds do
    not suffice (geometric growth makes that pathological).
    """
    with obs.span("adaptive.upload"):
        if isinstance(points, torch.Tensor):
            pts = points.to(torch.float32)
            est_pts = pts
        else:
            host_pts = np.asarray(points)
            pts = torch.as_tensor(host_pts, dtype=torch.float32).to(
                resolve_device(device))
            est_pts = pts
            if caps is None and host_pts.dtype != np.float32:
                # the estimate reads the caller's values: grid boundaries
                # of their float32 rounding may differ
                est_pts = torch.as_tensor(host_pts, dtype=torch.float64).to(
                    pts.device)
        if point_valid is not None:
            point_valid = torch.as_tensor(point_valid, dtype=torch.bool).to(
                pts.device)
    n, d = pts.shape
    if caps is None:
        caps = estimate_caps(est_pts, eps, min_pts, point_valid=point_valid,
                             use_kernels=bool(use_kernels))
    elif use_kernels is not None and caps.use_kernels != use_kernels:
        caps = dataclasses.replace(caps, use_kernels=use_kernels)

    def run(c):
        res = device_dbscan(pts, eps, min_pts, c, point_valid=point_valid)
        return res, OverflowReport.from_vector(
            host_read(res.report.as_vector()))

    result, attempts = adaptive_loop(
        run,
        lambda c, flags: grow_caps(c, flags, n=n, d=d, growth=growth),
        dataclasses.asdict, caps, max_retries)
    # occupancy-packed dispatch telemetry (device_dbscan module doc):
    # grids actually swept per tier vs the grid_cap slots the dense
    # strategy would sweep, from the host's own counts (no device read)
    tiers = result.tier_counts
    reg = obs.registry()
    for i in range(3):
        reg.gauge(f"device.dispatch.tier{i + 1}_grids").set(float(tiers[i]))
    reg.gauge("device.dispatch.dense_slots").set(float(tiers[3]))
    reg.gauge("device.dispatch.grids_swept").set(float(sum(tiers)))
    reg.gauge("device.dispatch.grid_cap").set(
        float(attempts[-1]["caps"]["grid_cap"]))
    return result, attempts
