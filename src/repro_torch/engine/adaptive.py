"""Adaptive-cap loop for the static-shape device pipeline.

The device GriT pipeline (``device_dbscan``) trades the paper's dynamic
data structures for static caps; every cap carries an overflow flag.

1. :func:`estimate_caps` derives an initial ``GritCaps`` from *host-side
   grid statistics* -- an O(n log n) pass: the non-empty-grid count
   bounds ``grid_cap``, the max grid occupancy bounds ``m_cap`` (core
   points per grid can never exceed occupancy), and the stencil bound
   (3^d - 1, clamped to the exact offset-stencil size) seeds ``k_cap``.
2. :func:`adaptive_device_dbscan` runs the pipeline, reads the per-cap
   :class:`OverflowReport` (one host read per attempt), geometrically
   grows exactly the caps that overflowed, and retries.  Caps are
   quantized to powers of two / block multiples, the same values as
   ``repro.engine.adaptive`` produces.

Growth is geometric (default 2x), so reaching a true bound B from an
under-estimate costs O(log B) attempts worst case; each cap is also
clamped at its provable maximum (e.g. candidates <= n, neighbors <= the
exact stencil size), so the loop terminates even on adversarial data.

The host statistics work on integer grid identifiers.  Where the
identifier rows fit a mixed-radix int64 key they are compared as such
keys (``_row_keys``) rather than as structured rows: the same
memberships and counts, found much faster at 10^6 points.
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
from ..core.grid_tree import offset_stencil, radius
from ..core.sync import host_read


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
    stencil offset -- O(|stencil| * G log G)."""
    pts = np.asarray(points, np.float64)
    if point_valid is not None:
        pts = pts[np.asarray(point_valid, bool)]
    if len(pts) == 0:
        return 1
    d = pts.shape[1]
    ids, _, _ = identifiers(pts, eps)
    uids, counts = _unique_rows(ids)
    small = counts < min_pts
    if not small.any():
        return 1
    r = radius(d)
    base = uids.max(axis=0) + 2 * r + 1
    keyed = _row_keys(uids, r, base) is not None
    to_keys = (lambda a: _row_keys(a, r, base)) if keyed else _lex_rows
    keys = to_keys(uids)                         # sorted (unique rows)
    totals = np.zeros(int(small.sum()), np.int64)
    deltas, _ = offset_stencil(d)
    for delta in np.asarray(deltas, np.int64):
        probe = to_keys(uids[small] + delta)
        pos = np.searchsorted(keys, probe)
        pos = np.minimum(pos, len(keys) - 1)
        hit = keys[pos] == probe
        totals += np.where(hit, counts[pos], 0)
    return int(totals.max())


def _caps_from_stats(n: int, d: int, num_grids: int, max_occ: int,
                     cand_max: int, margin: float, extra_grids: int,
                     use_kernels: bool) -> GritCaps:
    """``GritCaps`` from (grid count, max occupancy, max small-grid
    candidate total) -- the quantization/clamp discipline of the estimator."""
    grid_cap = _pow2_at_least(
        int(math.ceil(num_grids * margin)) + extra_grids, lo=8)
    grid_block = min(64, grid_cap)

    # 3^d - 1 stencil heuristic, clamped to the exact offset-stencil
    # size (the provable per-grid neighbor maximum); at low d the exact
    # bound is small enough to just provision outright
    bound = stencil_neighbor_bound(d)
    k_est = bound if bound <= 32 else max(3 ** d - 1, 8)
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

    # paper Theorem 3: FastMerging terminates within |s_i| + |s_j|
    # iterations; the batched loop stops once every pair is decided, so
    # a generous bound costs nothing
    merge_iters = 2 * m_cap + 4

    return GritCaps(grid_cap=grid_cap, frontier_cap=frontier_cap,
                    k_cap=k_cap, c_cap=c_cap, m_cap=m_cap,
                    pair_cap=pair_cap, grid_block=grid_block,
                    pair_block=pair_block, merge_iters=merge_iters,
                    use_kernels=use_kernels)


def estimate_caps(points: np.ndarray, eps: float, min_pts: int,
                  point_valid: Optional[np.ndarray] = None,
                  margin: float = 1.25,
                  extra_grids: int = 2,
                  use_kernels: bool = False) -> GritCaps:
    """Initial ``GritCaps`` from host grid statistics (see module doc).

    ``extra_grids`` reserves slots for the sentinel grids that padding
    points (``point_valid == False`` -> PAD_COORD) occupy.
    ``use_kernels`` selects the kernelized distance plane; it rides on
    the caps and is preserved by ``grow_caps``.
    """
    pts = np.asarray(points)
    n, d = pts.shape
    num_grids, max_occ = grid_stats(pts, eps, point_valid)
    cand_max = candidate_census(pts, eps, min_pts, point_valid)
    return _caps_from_stats(n, d, num_grids, max_occ, cand_max,
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

    Returns (result, attempts); raises :class:`CapOverflowError` with
    the full real attempt trail on exhaustion or clamp.
    """
    attempts: List[dict] = []
    for _ in range(max_retries + 1):
        result, report = run(caps)
        overflowed = report.overflowing()
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
    if isinstance(points, torch.Tensor):
        pts = points.to(torch.float32)
        host_pts = None
    else:
        host_pts = np.asarray(points)
        pts = torch.as_tensor(host_pts, dtype=torch.float32).to(
            resolve_device(device))
    if point_valid is not None:
        point_valid = torch.as_tensor(point_valid, dtype=torch.bool).to(
            pts.device)
    n, d = pts.shape
    if caps is None:
        if host_pts is None:
            host_pts = pts.cpu().numpy()
        caps = estimate_caps(host_pts, eps, min_pts,
                             point_valid=None if point_valid is None
                             else point_valid.cpu().numpy(),
                             use_kernels=bool(use_kernels))
    elif use_kernels is not None and caps.use_kernels != use_kernels:
        caps = dataclasses.replace(caps, use_kernels=use_kernels)

    def run(c):
        res = device_dbscan(pts, eps, min_pts, c, point_valid=point_valid)
        return res, OverflowReport.from_vector(
            host_read(res.report.as_vector()))

    return adaptive_loop(
        run,
        lambda c, flags: grow_caps(c, flags, n=n, d=d, growth=growth),
        dataclasses.asdict, caps, max_retries)
