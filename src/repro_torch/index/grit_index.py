"""Fitted GriT index: the persistent artifact of one clustering run.

``cluster()`` engines historically burned the grid tree, core flags and
merge structure they built and returned bare labels, so serving a second
query cost a full refit.  ``GritIndex`` captures that fitted state --
the lex-sorted grid identifier arrays (level tree rebuilt lazily),
per-grid point ranges, core flags, canonical labels, eps/MinPts and the
device caps of the fit -- and serves it (DESIGN.md §7):

* :meth:`predict` labels new points *exactly* under the DBSCAN
  assignment rule: a query is noise unless some core point lies within
  eps, else it takes the label of the nearest core point.  Candidates
  come from the grid tree (every core point within eps of a query lies
  in a grid at integer offset < d from the query's cell -- the paper's
  stencil bound -- so the tree query is a complete candidate
  enumeration, including for queries landing in empty cells or outside
  the fitted bounding box).  Three execution modes: ``host`` (float64
  numpy, bit-identical to the brute oracle's distance formula),
  ``kernel`` (slot-batched ``row_min_batch`` -- the CUDA kernel on the
  card, its plain version on the CPU -- with shapes grown through
  :class:`PredictCaps` like the adaptive loop's caps) and ``device``
  (the resident guard-band plane of ``device_state``, bit-identical to
  ``host``).
* :meth:`insert` / :meth:`delete` mutate the fitted state through one
  shared *delta engine* (``repro_torch.index.delta``): both directions
  recompute core status and merge decisions only in the offset-stencil
  of the touched grids, maintain the **persistent core-grid merge
  graph** (:attr:`merge_edges` -- the first-class structure cluster
  identity is recomputed from), and reconcile labels by connected
  components over it.  Deletes tombstone rows first; a
  threshold-triggered :meth:`compact` re-packs the flat arrays.
* :meth:`snapshot` / :meth:`restore` serialize the whole fitted state
  as a dict of flat numpy arrays (``np.savez``-able), so a fitted index
  ships between processes without refitting.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch

from ..core.grids import GridIndex, build_grids, group_rows
from ..core.grid_tree import GridTree
from ..core.device_dbscan import GritCaps
from ..engine.adaptive import _pow2_at_least, resolve_device

from .delta import MutationLog
from .snapshot_io import (check_version, load_snapshot, save_snapshot)

# v2 adds the mutation-plane state: ``alive`` tombstone flags,
# ``next_arrival`` and the persistent merge-graph edge array.  v1
# snapshots stay restorable (no tombstones; merge graph rebuilt lazily
# on the first mutation that needs it).
_SNAPSHOT_VERSION = 2
_ACCEPTED_VERSIONS = (1, 2)


@dataclasses.dataclass
class PredictCaps:
    """Static shapes of the batched kernel predict path.

    Mirrors the adaptive loop's cap discipline: power-of-two
    quantization so similarly-shaped query batches share one set of
    buffer sizes, and never silent truncation -- the host packs the
    slots, so an overflow is *detected before* the kernel runs.  Each
    call packs at its own batch's pow2 bucket (one historical
    mega-batch must not inflate every later small predict); the index
    keeps a monotone *record* of the largest shapes seen.
    """

    group_cap: int = 0      # distinct query grids per call
    query_cap: int = 0      # queries per grid slot
    cand_cap: int = 0       # candidate core points per grid slot

    @classmethod
    def for_batch(cls, groups: int, queries: int, cands: int
                  ) -> "PredictCaps":
        return cls(group_cap=_pow2_at_least(groups, lo=8),
                   query_cap=_pow2_at_least(queries, lo=8),
                   cand_cap=_pow2_at_least(cands, lo=32))

    def grown_to(self, other: "PredictCaps") -> Tuple["PredictCaps", bool]:
        new = PredictCaps(
            group_cap=max(self.group_cap, other.group_cap),
            query_cap=max(self.query_cap, other.query_cap),
            cand_cap=max(self.cand_cap, other.cand_cap))
        return new, new != self


@dataclasses.dataclass
class GritIndex:
    """Fitted state of one GriT-DBSCAN run, in grid-sorted order.

    All per-point arrays are in *sorted* (lexicographic grid) order;
    ``arrival`` maps a sorted row back to its arrival index (fit points
    keep their original order 0..n_fit-1, inserted batches append).
    Stored identifiers satisfy ``ids >= 0``; ``id_shift`` records the
    integer translation applied when inserts extend the bounding box
    below the fitted origin, so the identifier of any coordinate is
    always ``floor((x - mins) / side) + id_shift`` -- the fit-time
    formula, never re-derived from a moved origin (which could re-cell
    points through float rounding).
    """

    points: np.ndarray        # [n, d] float64, sorted by grid id
    arrival: np.ndarray       # [n] int64 arrival index of each sorted row
    ids: np.ndarray           # [G, d] int64 lex-sorted non-empty grid ids
    starts: np.ndarray        # [G] int64 first sorted row of each grid
    counts: np.ndarray        # [G] int64 physical rows per grid
    core: np.ndarray          # [n] bool (sorted order; False on dead rows)
    labels: np.ndarray        # [n] int64 (sorted order; -1 noise/dead)
    eps: float
    min_pts: int
    side: float               # eps / sqrt(d), exactly as fit
    mins: np.ndarray          # [d] float64 fit-time identifier origin
    id_shift: np.ndarray      # [d] int64 (see class docstring)
    next_label: int           # smallest unused cluster id
    caps: Optional[GritCaps] = None   # caps of the device fit
    predict_caps: PredictCaps = dataclasses.field(default_factory=PredictCaps)
    # -- mutation-plane state (repro_torch.index.delta) ----------------
    # Deleted rows *tombstone* first (alive=False, core=False, label=-1,
    # physical row kept so the CSR layout and grid numbering survive);
    # compact() re-packs once dead_fraction crosses compact_threshold.
    # Arrival ids are never reused: next_arrival is the id the next
    # inserted point gets, so delete(ids) stays unambiguous forever.
    alive: Optional[np.ndarray] = None        # [n] bool
    live_counts: Optional[np.ndarray] = None  # [G] live points per grid
    next_arrival: int = -1
    # The persistent core-grid merge graph: [E, 2] int64 grid-index
    # pairs (i < j, lex-sorted, deduped) with MinDist(cores_i, cores_j)
    # <= eps.  None = not built yet (v1 snapshots / fresh fits); the
    # delta engine builds it lazily on the first mutation and then
    # maintains it incrementally in both directions.  Cluster identity
    # of core points is exactly the connected components of this graph.
    merge_edges: Optional[np.ndarray] = None
    compact_threshold: float = 0.25
    _tree: Optional[GridTree] = dataclasses.field(
        default=None, repr=False, compare=False)
    _core_csr: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    _arr_to_row: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    # Device-resident serving state (repro_torch.index.device_state):
    # tensor mirrors of the serving-hot arrays, attached explicitly via
    # ensure_device_state().  Host numpy stays authoritative -- the
    # mirror is derived state (like _tree), never snapshotted.
    device_state: Optional[Any] = dataclasses.field(
        default=None, repr=False, compare=False)
    # Replication cursor: ops_applied counts the top-level
    # insert/delete batches this index has absorbed -- the cursor a read
    # replica replays from -- and, once a MutationLog is attached
    # (enable_mutation_log), every such batch is appended verbatim after
    # it applies.  The log is runtime state, never snapshotted; a
    # restored clone starts its count at 0 (the snapshot stays v2).
    ops_applied: int = 0
    mutation_log: Optional[MutationLog] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.alive is None:
            self.alive = np.ones(self.points.shape[0], bool)
        if self.live_counts is None:
            self.live_counts = np.asarray(self.counts, np.int64).copy()
        if self.next_arrival < 0:
            self.next_arrival = int(self.arrival.max(initial=-1)) + 1

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_fit(cls, points, eps: float, min_pts: int, labels,
                 core=None, grid: Optional[GridIndex] = None,
                 caps: Optional[GritCaps] = None) -> "GritIndex":
        """Build the index from one finished fit (arrival-order arrays).

        ``grid`` reuses an engine's float64 host partition when it
        carried one (``ClusterResult.grid``); ``core=None`` (e.g. the
        distributed engine) triggers a grid-based core identification --
        still O(n * stencil), never the O(n^2) oracle.
        """
        pts = np.asarray(points, np.float64)
        n, d = pts.shape
        labels = np.asarray(labels, np.int64)
        assert labels.shape == (n,), labels.shape
        gi = grid if isinstance(grid, GridIndex) else build_grids(pts, eps)
        if core is None:
            from ..core.dbscan import _identify_cores
            tree = GridTree.build(gi.ids)
            indptr, nbr, _ = tree.query(gi.ids, include_self=False)
            core = _identify_cores(pts, gi, indptr, nbr, eps, min_pts, {})
        core = np.asarray(core, bool)
        order = np.asarray(gi.order, np.int64)
        return cls(
            points=pts[order], arrival=order,
            ids=np.asarray(gi.ids, np.int64).copy(),
            starts=np.asarray(gi.starts, np.int64).copy(),
            counts=np.asarray(gi.counts, np.int64).copy(),
            core=core[order], labels=labels[order],
            eps=float(eps), min_pts=int(min_pts), side=float(gi.side),
            mins=np.asarray(gi.mins, np.float64).copy(),
            id_shift=np.zeros(d, np.int64),
            next_label=int(labels.max(initial=-1)) + 1, caps=caps)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    @property
    def n(self) -> int:
        """Physical rows (tombstoned rows included until compaction)."""
        return int(self.points.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    @property
    def dead_fraction(self) -> float:
        n = self.n
        return (n - self.n_live) / n if n else 0.0

    @property
    def d(self) -> int:
        return int(self.points.shape[1])

    @property
    def num_grids(self) -> int:
        return int(self.ids.shape[0])

    @property
    def tree(self) -> GridTree:
        if self._tree is None:
            self._tree = GridTree.build(self.ids)
        return self._tree

    @property
    def fit_grid(self) -> GridIndex:
        """The current *live* partition as a host ``GridIndex``.

        Identifiers are returned in the canonical origin (``id_shift``
        subtracted), so the ``GridIndex`` invariant
        ``ids == floor((x - mins) / side)`` holds even after inserts
        extended the bounding box; a uniform integer shift preserves
        the lexicographic order, so the CSR layout is unchanged.  Rows
        are indexed in arrival *rank* order (live points sorted by
        arrival id -- identical to arrival order until a delete
        tombstones rows).
        """
        grid_of = np.repeat(np.arange(self.num_grids, dtype=np.int64),
                            self.counts)
        live = np.flatnonzero(self.alive)
        rank = np.argsort(self.arrival[live], kind="stable")
        keep = self.live_counts > 0
        new_of_old = np.cumsum(keep) - 1          # grid renumbering
        order = np.empty(len(live), np.int64)
        order[rank] = np.arange(len(live))
        point_grid = new_of_old[grid_of[live]][rank]
        ids = self.ids[keep] - self.id_shift[None, :]
        starts = np.cumsum(self.live_counts[keep]) - self.live_counts[keep]
        return GridIndex(order=order, ids=ids,
                         starts=starts, counts=self.live_counts[keep].copy(),
                         point_grid=point_grid, side=self.side,
                         mins=self.mins.copy(),
                         eta=int(ids.max(initial=0)))

    def labels_arrival(self) -> np.ndarray:
        """Labels of the *live* points, ordered by arrival id (fit
        points first, inserts appended; deleted rows omitted)."""
        live = self.alive
        return self.labels[live][np.argsort(self.arrival[live],
                                            kind="stable")]

    def core_arrival(self) -> np.ndarray:
        """Core flags of the live points, ordered by arrival id."""
        live = self.alive
        return self.core[live][np.argsort(self.arrival[live],
                                          kind="stable")]

    def points_arrival(self) -> np.ndarray:
        """Coordinates of the live points, ordered by arrival id (the
        surviving set :meth:`labels_arrival` labels, row for row)."""
        live = self.alive
        return self.points[live][np.argsort(self.arrival[live],
                                            kind="stable")]

    def arrival_live(self) -> np.ndarray:
        """Sorted arrival ids of the surviving points (what
        :meth:`labels_arrival` rows correspond to)."""
        return np.sort(self.arrival[self.alive])

    def rows_of_arrival(self, arrival_ids: np.ndarray) -> np.ndarray:
        """Sorted-order rows holding the given arrival ids (-1 where an
        id was never assigned or its row is tombstoned)."""
        if self._arr_to_row is None:
            a2r = np.full(self.next_arrival, -1, np.int64)
            live = np.flatnonzero(self.alive)
            a2r[self.arrival[live]] = live
            self._arr_to_row = a2r
        ids = np.asarray(arrival_ids, np.int64)
        out = np.full(ids.shape, -1, np.int64)
        ok = (ids >= 0) & (ids < self.next_arrival)
        out[ok] = self._arr_to_row[ids[ok]]
        return out

    def labels_at(self, arrival_ids: np.ndarray) -> np.ndarray:
        """Labels of specific (live) arrival ids; -1 for dead/unknown."""
        rows = self.rows_of_arrival(arrival_ids)
        out = np.full(rows.shape, -1, np.int64)
        ok = rows >= 0
        out[ok] = self.labels[rows[ok]]
        return out

    def core_at(self, arrival_ids: np.ndarray) -> np.ndarray:
        """Core flags of specific (live) arrival ids; False for dead."""
        rows = self.rows_of_arrival(arrival_ids)
        out = np.zeros(rows.shape, bool)
        ok = rows >= 0
        out[ok] = self.core[rows[ok]]
        return out

    def invalidate(self, keep_tree: bool = False) -> None:
        """Drop derived caches after a structural mutation.

        ``keep_tree=True`` preserves the level tree when the grid id
        array is untouched (deletes tombstone in place, so only the
        row-level caches go stale)."""
        if not keep_tree:
            self._tree = None
        self._core_csr = None
        self._arr_to_row = None

    # ------------------------------------------------------------------
    # identifiers + candidate enumeration
    # ------------------------------------------------------------------

    def query_ids(self, points: np.ndarray) -> np.ndarray:
        """Grid identifiers of arbitrary coordinates (may be negative or
        beyond the fitted range -- the tree query handles both)."""
        q = np.asarray(points, np.float64)
        return (np.floor((q - self.mins[None, :]) / self.side)
                .astype(np.int64) + self.id_shift[None, :])

    def _core_ranges(self):
        """Per-grid core-point rows: (core_rows [k], cstarts [G],
        ccounts [G]) -- core rows are ascending, hence grouped by grid."""
        if self._core_csr is None:
            core_rows = np.flatnonzero(self.core)
            cstarts = np.searchsorted(core_rows, self.starts)
            cends = np.searchsorted(core_rows, self.starts + self.counts)
            self._core_csr = (core_rows, cstarts, cends - cstarts)
        return self._core_csr

    def grid_core_rows(self, g: int) -> np.ndarray:
        """Sorted-order rows of grid ``g``'s core points."""
        core_rows, cstarts, ccounts = self._core_ranges()
        return core_rows[cstarts[g]:cstarts[g] + ccounts[g]]

    def _candidate_cores(self, q_ids: np.ndarray):
        """Core-point candidates for each query identifier.

        Returns ``(rows, q_of)``: candidate sorted-order rows and the
        query each belongs to.  Complete by the stencil bound (module
        docstring); queries in empty cells simply contribute the cores
        of their non-empty stencil neighbors (possibly none).
        """
        indptr, grids, _ = self.tree.query(q_ids, include_self=True)
        core_rows, cstarts, ccounts = self._core_ranges()
        per = ccounts[grids]                                   # [E]
        total = int(per.sum())
        base = np.repeat(np.cumsum(per) - per, per)            # [T]
        pos = np.arange(total, dtype=np.int64) - base
        rows = core_rows[np.repeat(cstarts[grids], per) + pos]
        q_of_entry = np.repeat(np.arange(len(q_ids), dtype=np.int64),
                               np.diff(indptr))
        q_of = np.repeat(q_of_entry, per)
        return rows, q_of

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------

    def predict(self, queries, *, mode: str = "auto", chunk: int = 2048,
                stats: Optional[dict] = None, return_d2: bool = False,
                device=None):
        """Label new points under the DBSCAN assignment rule (exact).

        Args:
          queries: [m, d] array-like; any coordinates (empty cells,
            outside the fitted bounding box, ... all fine).
          mode: "host" (float64 numpy -- bit-identical to the brute
            oracle), "kernel" (slot-batched ``row_min_batch``, float32
            with per-grid re-centering), "device" (resident-buffer
            guard-band path -- float32 distances for the certain
            queries, host float64 for the band, output bit-identical
            to "host"), or "auto" (device when a resident state is
            attached, else kernel on the CUDA device / host on the CPU).
          chunk: host-mode query chunk (memory bound).
          stats: optional dict filled with execution counters
            (mode, candidate totals, kernel cap growth).
          return_d2: also return [m] float64 squared distances to the
            nearest core candidate (inf where none) -- what a sharded
            router needs to combine answers from several slabs.
          device: where "kernel" mode runs and what "auto" picks for.
            ``None`` is the CUDA device (``RuntimeError`` when there is
            none); ``"cpu"`` runs the kernel's plain version and makes
            "auto" pick "host".  "device" mode attaches the resident
            state on this device if none is attached yet.

        Returns [m] int64 labels; -1 noise (``(labels, d2)`` under
        ``return_d2``).  Never mutates the fitted state; kernel mode may
        grow ``predict_caps`` (monotone), so concurrent kernel predicts
        on one shared index need external serialization.
        """
        q = np.asarray(queries, np.float64)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(
                f"queries must be [m, {self.d}], got {q.shape}")
        if q.shape[0] == 0:
            out = np.empty(0, np.int64)
            return (out, np.empty(0, np.float64)) if return_d2 else out
        if not np.isfinite(q).all():
            raise ValueError("queries contain non-finite coordinates")
        if mode == "auto":
            if self.device_state is not None:
                mode = "device"
            else:
                mode = ("kernel" if resolve_device(device).type == "cuda"
                        else "host")
        if stats is not None:
            stats["mode"] = mode
            stats["n_queries"] = int(q.shape[0])
        if not self.core.any():
            # no live cores (e.g. everything deleted): every query is
            # noise by the assignment rule -- skip the (possibly empty)
            # tree entirely
            out = np.full(q.shape[0], -1, np.int64)
            if stats is not None:
                stats["candidates"] = 0
            d2 = np.full(q.shape[0], np.inf, np.float64)
            return (out, d2) if return_d2 else out
        if mode == "host":
            out, d2 = self._predict_host(q, chunk, stats)
        elif mode == "kernel":
            out, d2 = self._predict_kernel(q, stats, device)
        elif mode == "device":
            out, d2 = self._predict_device(q, stats, device)
        else:
            raise ValueError(f"unknown predict mode {mode!r}")
        return (out, d2) if return_d2 else out

    def predict_async(self, queries, *, mode: str = "auto",
                      chunk: int = 2048, stats: Optional[dict] = None,
                      return_d2: bool = False, device=None):
        """Two-phase :meth:`predict`: dispatch now, block later.

        Returns a zero-argument ``resolve()`` producing exactly what
        :meth:`predict` would.  On the device path the distance work is
        enqueued on the device before this returns and ``resolve()``
        blocks on it, so a caller can pack the next batch meanwhile.
        Other modes compute eagerly (``resolve()`` just hands the answer
        back), so callers need no mode-specific branches.
        """
        q = np.asarray(queries, np.float64)
        if mode == "auto" and self.device_state is not None:
            mode = "device"
        if (mode != "device" or q.shape[0] == 0
                or not self.core.any()):
            out = self.predict(q, mode=mode, chunk=chunk, stats=stats,
                               return_d2=return_d2, device=device)
            return lambda: out
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(
                f"queries must be [m, {self.d}], got {q.shape}")
        if not np.isfinite(q).all():
            raise ValueError("queries contain non-finite coordinates")
        self.ensure_device_state(device)
        if stats is not None:
            stats["mode"] = "device"
            stats["n_queries"] = int(q.shape[0])
        from . import device_state as _dsm
        resolver = _dsm.predict_device_async(self, self.device_state,
                                             q, stats)

        def resolve():
            out, d2 = resolver()
            return (out, d2) if return_d2 else out

        return resolve

    def _predict_device(self, q: np.ndarray, stats: Optional[dict],
                        device=None):
        from . import device_state as _dsm
        self.ensure_device_state(device)
        return _dsm.predict_device(self, self.device_state, q, stats)

    def _predict_host(self, q: np.ndarray, chunk: int,
                      stats: Optional[dict]):
        eps2 = self.eps * self.eps
        m = q.shape[0]
        out = np.full(m, -1, np.int64)
        out_d2 = np.full(m, np.inf, np.float64)
        q_ids = self.query_ids(q)
        n_cand = 0
        for s in range(0, m, chunk):
            nq = min(chunk, m - s)
            rows, q_of = self._candidate_cores(q_ids[s:s + chunk])
            n_cand += len(rows)
            if len(rows) == 0:
                continue
            d2 = ((self.points[rows] - q[s + q_of]) ** 2).sum(axis=1)
            # nearest candidate per query; ``q_of`` is nondecreasing by
            # construction, so a segmented reduce beats a global sort
            cnt = np.bincount(q_of, minlength=nq)
            ne = cnt > 0
            seg = (np.cumsum(cnt) - cnt)[ne]
            dmin = np.minimum.reduceat(d2, seg)
            # argmin = first candidate matching its segment's minimum
            is_min = d2 == np.repeat(dmin, cnt[ne])
            pos = np.flatnonzero(is_min)
            qpos, first = np.unique(q_of[pos], return_index=True)
            best = pos[first]
            out_d2[s + qpos] = d2[best]
            hit = d2[best] <= eps2
            out[s + qpos[hit]] = self.labels[rows[best[hit]]]
        if stats is not None:
            stats["candidates"] = n_cand
        return out, out_d2

    def _predict_kernel(self, q: np.ndarray, stats: Optional[dict],
                        device=None):
        """Slot-batched predict: queries grouped by grid cell, one
        ``row_min_batch`` call on (group_cap, query_cap, cand_cap)
        padded slots -- the CUDA kernel for a CUDA ``device``, its plain
        version on the CPU.  Both operands are re-centered on the
        group's cell origin so the float32 distances run on
        stencil-scale coordinates (same policy as the device pipeline's
        kernel plane)."""
        from ..kernels import ops as kernel_ops

        dev = resolve_device(device)
        eps2 = np.float32(self.eps) ** 2
        m = q.shape[0]
        q_ids = self.query_ids(q)
        # group queries sharing a cell: they share the candidate set
        qorder, sq, gstart, gcount, _ = group_rows(q_ids)
        B = len(gstart)
        rep_ids = sq[gstart]
        rows, g_of = self._candidate_cores(rep_ids)
        cand_per = np.zeros(B, np.int64)
        np.add.at(cand_per, g_of, 1)
        pc = PredictCaps.for_batch(B, int(gcount.max()),
                                   int(cand_per.max(initial=1)))
        self.predict_caps, grew = self.predict_caps.grown_to(pc)
        if stats is not None:
            stats.update(groups=B, candidates=int(len(rows)),
                         caps=dataclasses.asdict(pc), caps_grew=grew)

        a = np.zeros((pc.group_cap, pc.query_cap, self.d), np.float64)
        b = np.zeros((pc.group_cap, pc.cand_cap, self.d), np.float64)
        vb = np.zeros((pc.group_cap, pc.cand_cap), bool)
        brow = np.zeros((pc.group_cap, pc.cand_cap), np.int64)
        # scatter queries into their group's slot row (same flat-offset
        # pattern as the candidate scatter below)
        qgroup = np.repeat(np.arange(B, dtype=np.int64), gcount)
        qslot = np.arange(m, dtype=np.int64) - np.repeat(gstart, gcount)
        a[qgroup, qslot] = q[qorder]
        qslot_of = np.empty(m, np.int64)      # flat slot of each query
        qslot_of[qorder] = qgroup * pc.query_cap + qslot
        cbase = np.cumsum(cand_per) - cand_per
        slot = np.arange(len(rows)) - np.repeat(cbase, cand_per)
        b[g_of, slot] = self.points[rows]
        vb[g_of, slot] = True
        brow[g_of, slot] = rows
        # re-center on each group's cell origin (float64 subtract, then
        # cast -- stencil-scale coordinates for the f32 kernel)
        anchor = (self.mins[None, :]
                  + (rep_ids - self.id_shift[None, :]) * self.side)
        anchor = np.concatenate(
            [anchor, np.zeros((pc.group_cap - B, self.d))])[:, None, :]
        dmin_dev, argi_dev = kernel_ops.row_min_batch(
            # grit-lint: disable=hot-path-sync -- KNOWN: the query slots' upload from pageable host memory waits for the card
            torch.from_numpy((a - anchor).astype(np.float32)).to(dev),
            # grit-lint: disable=hot-path-sync -- KNOWN: the candidate slots' upload waits for the card
            torch.from_numpy((b - anchor).astype(np.float32)).to(dev),
            # grit-lint: disable=hot-path-sync -- KNOWN: the validity mask's upload waits for the card
            valid_b=torch.from_numpy(vb).to(dev))
        # grit-lint: disable=hot-path-sync -- the predict kernel's intended block point: the labels need the row minima, which wait for the kernel
        dmin = dmin_dev.cpu().numpy().reshape(-1)
        argi = argi_dev.cpu().numpy().reshape(-1)  # grit-lint: disable=hot-path-sync -- KNOWN: a second blocking copy after the block point above; one transfer of both outputs would remove it
        out = np.full(m, -1, np.int64)
        dq = dmin[qslot_of]
        aq = argi[qslot_of]
        hit = (dq <= eps2) & (aq >= 0)
        gq = qslot_of // pc.query_cap
        out[hit] = self.labels[brow[gq[hit], aq[hit]]]
        out_d2 = np.where(aq >= 0, dq.astype(np.float64), np.inf)
        return out, out_d2

    # ------------------------------------------------------------------
    # mutation plane (repro_torch.index.delta)
    # ------------------------------------------------------------------

    def ensure_merge_graph(self) -> np.ndarray:
        """The persistent core-grid merge graph, building it if absent.

        Returns the ``[E, 2]`` edge array (grid-index pairs, i < j).
        Built once from the fitted state (FastMerging over every
        core-grid neighbor pair -- the cost shape of one fit's merging
        phase), then maintained incrementally by insert/delete."""
        if self.merge_edges is None:
            from .delta import build_merge_graph
            self.merge_edges = build_merge_graph(self)
        return self.merge_edges

    def ensure_device_state(self, device=None):
        """Attach (or return) the device-resident serving state.

        Uploads the CSR-sorted points, core/alive flags, grid ranges
        and merge edges as tensors on ``device`` (``None``: the CUDA
        device, ``RuntimeError`` when there is none; ``"cpu"`` for
        tests); predict and the delta engine's hot stages then compute
        their distances there (guard-band exact -- outputs stay
        bit-identical to the host path).  The mirror follows every
        mutation automatically.  An attached state is returned as it
        is, whatever ``device`` says."""
        if self.device_state is None:
            from . import device_state as _dsm
            self.device_state = _dsm.DeviceState(self, device=device)
        return self.device_state

    def drop_device_state(self) -> None:
        """Detach the resident mirror (serving falls back to host)."""
        self.device_state = None

    def enable_mutation_log(self) -> MutationLog:
        """Attach (or return) the replication log.

        From this call on, every top-level :meth:`insert` /
        :meth:`delete` batch is appended verbatim; the log base is the
        current :attr:`ops_applied`, so a replica cloned from a
        snapshot taken *now* starts exactly at the log base."""
        if self.mutation_log is None:
            self.mutation_log = MutationLog(base=self.ops_applied)
        return self.mutation_log

    def _log_mutation(self, op: str, payload: np.ndarray) -> None:
        self.ops_applied += 1
        if self.mutation_log is not None:
            self.mutation_log.append(op, payload)

    def insert(self, points) -> Dict[str, Any]:
        """Micro-batch incremental insert (stats schema: see
        :func:`repro_torch.index.delta.insert_batch`)."""
        from .delta import insert_batch
        pts = np.asarray(points, np.float64)
        st = insert_batch(self, pts)
        self._log_mutation("insert", pts)
        return st

    def delete(self, arrival_ids) -> Dict[str, Any]:
        """Exact micro-batch delete by arrival id (stats schema: see
        :func:`repro_torch.index.delta.delete_ids`).  Unknown or already
        deleted ids are rejected, not raised -- serving traffic carries
        them routinely (double deletes, TTL races); they stay in the
        mutation-log record (a replay rejects them identically)."""
        from .delta import delete_ids
        ids = np.asarray(arrival_ids, np.int64)
        st = delete_ids(self, ids)
        self._log_mutation("delete", ids)
        return st

    def compact(self) -> Dict[str, Any]:
        """Re-pack the flat arrays, dropping tombstoned rows (called
        automatically by :meth:`delete` past ``compact_threshold``)."""
        from .delta import compact
        return compact(self)

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Flat-array serialization of the whole fitted state.

        Every value is a numpy array (``np.savez(path, **snap)`` works
        directly); scalars are packed into small arrays.  Derived
        structures (level tree, core CSR, predict caps) are rebuilt on
        :meth:`restore`, not shipped.
        """
        caps = np.zeros(0, np.int64)
        if self.caps is not None:
            f = dataclasses.asdict(self.caps)
            # the 11th slot (dispatch strategy) is appended after the
            # original fixed-10 layout; restore accepts both lengths
            caps = np.asarray(
                [f["grid_cap"], f["frontier_cap"], f["k_cap"], f["c_cap"],
                 f["m_cap"], f["pair_cap"], f["grid_block"],
                 f["pair_block"], f["merge_iters"],
                 int(f["use_kernels"]), int(f["packed"])], np.int64)
        return {
            "version": np.asarray([_SNAPSHOT_VERSION], np.int64),
            "points": self.points, "arrival": self.arrival,
            "ids": self.ids, "starts": self.starts, "counts": self.counts,
            "core": self.core, "labels": self.labels,
            "mins": self.mins, "id_shift": self.id_shift,
            "scalars_f": np.asarray([self.eps, self.side], np.float64),
            "scalars_i": np.asarray([self.min_pts, self.next_label,
                                     self.next_arrival], np.int64),
            "caps": caps,
            # v2: mutation-plane state.  ``has_merge_graph``
            # distinguishes a built-but-empty graph (no merges) from an
            # absent one (rebuild lazily on restore).
            "alive": self.alive,
            "live_counts": self.live_counts,
            "merge_edges": (self.merge_edges if self.merge_edges is not None
                            else np.zeros((0, 2), np.int64)),
            "has_merge_graph": np.asarray(
                [self.merge_edges is not None], bool),
        }

    @classmethod
    def restore(cls, snap: Dict[str, np.ndarray]) -> "GritIndex":
        """Rebuild a fitted index from :meth:`snapshot` output (accepts
        an ``np.load`` mapping of a saved ``.npz`` as well).  Previous-
        version snapshots restore too: a v1 snapshot has no tombstones
        and no merge graph (rebuilt lazily by the first mutation)."""
        version = check_version(snap, "version", _ACCEPTED_VERSIONS,
                                "snapshot")
        caps_arr = np.asarray(snap["caps"])
        caps = None
        if caps_arr.size:
            v = [int(x) for x in caps_arr]
            caps = GritCaps(grid_cap=v[0], frontier_cap=v[1], k_cap=v[2],
                            c_cap=v[3], m_cap=v[4], pair_cap=v[5],
                            grid_block=v[6], pair_block=v[7],
                            merge_iters=v[8], use_kernels=bool(v[9]),
                            # pre-packed-dispatch snapshots carry 10
                            # slots; packed defaults on for them (a
                            # dispatch strategy, not fitted state)
                            packed=bool(v[10]) if len(v) > 10 else True)
        sf = np.asarray(snap["scalars_f"], np.float64)
        si = np.asarray(snap["scalars_i"], np.int64)
        merge_edges = None
        alive = live_counts = None
        next_arrival = -1
        if version >= 2:
            alive = np.asarray(snap["alive"], bool)
            live_counts = np.asarray(snap["live_counts"], np.int64)
            next_arrival = int(si[2])
            if bool(np.asarray(snap["has_merge_graph"])[0]):
                merge_edges = np.asarray(snap["merge_edges"],
                                         np.int64).reshape(-1, 2)
        return cls(
            points=np.asarray(snap["points"], np.float64),
            arrival=np.asarray(snap["arrival"], np.int64),
            ids=np.asarray(snap["ids"], np.int64),
            starts=np.asarray(snap["starts"], np.int64),
            counts=np.asarray(snap["counts"], np.int64),
            core=np.asarray(snap["core"], bool),
            labels=np.asarray(snap["labels"], np.int64),
            eps=float(sf[0]), min_pts=int(si[0]), side=float(sf[1]),
            mins=np.asarray(snap["mins"], np.float64),
            id_shift=np.asarray(snap["id_shift"], np.int64),
            next_label=int(si[1]), caps=caps,
            alive=alive, live_counts=live_counts,
            next_arrival=next_arrival, merge_edges=merge_edges)

    def save(self, path) -> None:
        save_snapshot(path, self.snapshot())

    @classmethod
    def load(cls, path) -> "GritIndex":
        return cls.restore(load_snapshot(path))
