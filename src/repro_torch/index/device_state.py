"""Device-resident serving state for a fitted :class:`GritIndex`.

Serving from host numpy alone gathers float64 candidates per call, and
the delta engine's core-recompute / merge re-decision / border stages
run per-grid Python loops.  This module keeps the fitted state
*resident* -- the CSR-sorted points, core/alive flags, grid ranges and
merge-edge arrays live as tensors on one device (:class:`DeviceState`)
-- and computes each hot stage's distances in one *flat ragged* gather
(``repro_torch.kernels.ops.pairwise_d2_flat`` /
``pairwise_d2_flat_res``), with host code reduced to packing flat gather
indices and running the segmented ``reduceat`` reductions.  Stages
whose flat element count falls under the adaptive gates
(``MIN_FLAT_T`` / ``EDGE_MIN_FLAT_T``) run their host float64 twin
outright -- pure performance routing, the twin is the reference.

**Bit-exactness by guard band.**  GriT-DBSCAN's value is *exact*
DBSCAN, so float32 distances never get the last word.  Points are
stored float32 origin-centered; every distance the device produces
carries a provable absolute error below ``band * eps^2`` where
``band = 32 * sqrt(d) * (d+1) * max(span/eps, 1) * 2**-24`` (span =
largest |coordinate - origin| ever resident; monotone).  Each stage
only accepts a float32 answer when it is *certain under the band*:

* core counts: ``count_lo`` hits at ``eps*sqrt(1-band)``, ``count_hi``
  at ``eps*sqrt(1+band)`` bracket the exact count -- core is certain
  iff ``base + count_lo >= MinPts``, non-core iff
  ``base + count_hi < MinPts``;
* merge edges: pair-min ``<= eps2*(1-band)`` proves the edge,
  ``> eps2*(1+band)`` refutes it;
* predict / border argmins: accepted only when the runner-up gap
  ``min2 - min > 2*band*eps2`` proves the float64 argmin is the same
  row (the winning distance is then *re-derived in float64* on host,
  so emitted labels and d2 are bit-identical to the host path).

Everything else -- the uncertain band -- falls back to the *same* host
float64 code the reference path runs, on exactly the uncertain subset.
All host stages are per-row / per-pair independent, so subset fallback
equals a full host run: the device path is bit-identical to
``device_state=None`` serving by construction.  The float32 distances
may differ in the last bit from another framework's (summation order,
fused multiply-adds); the band's 8x safety factor covers that, so only
the ``uncertain`` / ``band_fallback`` / ``dist_evals`` counters can
differ, never a label or a distance.

Buffer policy: tombstones and core flips update the resident flag
tensors in place (``index_fill_``); structural rewrites (splice,
compact, cap growth) re-upload.  The small CSR / merge-edge mirrors
re-ship per mutation.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import obs
from ..core.grids import group_rows
from ..engine.adaptive import ResidentCaps, resolve_device
from ..kernels import ops as kernel_ops

from .delta import (_bbox_survivors, _border_pass_host, _core_count_per_grid,
                    _decide_edges_batch, _recompute_cores_host)

_BAND_SAFETY = 32.0   # x8 over the worst-case f32 error bound


# --------------------------------------------------------------------------
# host packing helpers (the only work left on host in the hot loop)
# --------------------------------------------------------------------------

def _expand(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(starts[k], starts[k]+counts[k])`` ranges."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.cumsum(counts) - counts
    return np.repeat(starts - offs, counts) + np.arange(total)


def _row_cross(a_vals: np.ndarray, a_sizes: np.ndarray,
               a_offs: np.ndarray, b_vals: np.ndarray,
               b_sizes: np.ndarray, b_offs: np.ndarray,
               sel: np.ndarray):
    """Flat per-row cross-product layout for the delta stages.

    For each group ``k`` in ``sel`` (order kept) and each of its ``a``
    elements (order kept), emit one *segment* holding ``k``'s full
    ``b`` list (order kept -- the host candidate order, so first-min
    tie-breaks match).  Returns ``(ra, rb, seg, row_pos, row_k)``: the
    [T] flat operands, the per-segment lengths, each segment's flat
    position into ``a_vals``'s CSR, and its ``sel`` slot.  Zero padding
    waste; one gather covers every group.
    """
    rows_per = a_sizes[sel]
    row_pos = _expand(a_offs[sel], rows_per)
    row_k = np.repeat(np.arange(len(sel)), rows_per)
    seg = b_sizes[sel][row_k]
    ra = np.repeat(a_vals[row_pos], seg)
    rb = b_vals[_expand(b_offs[sel][row_k], seg)]
    return ra, rb, seg, row_pos, row_k


# below this flat element count a delta stage runs its host float64
# twin instead of dispatching: upload + dispatch + sync overhead on a
# tiny batch exceeds the f32 math win, and the host twin IS the
# reference the device path is pinned against, so the shortcut cannot
# change any output.  The values are the reference's (tuned there on a
# CPU backend); they are module parameters so a run on the card can
# move them.  Large mutations and every predict stay on the device.
MIN_FLAT_T = 1 << 15
# the edge decider's host twin early-terminates per pair (most
# re-decided edges are confirmed by the first probe), while the flat
# gather always pays the full cross product -- so its crossover sits
# far higher than the count-every-pair stages above
EDGE_MIN_FLAT_T = 1 << 20


def _to_dev(ds, arr: np.ndarray) -> torch.Tensor:
    # grit-lint: disable=hot-path-sync -- KNOWN: a copy from pageable host memory waits for the card; every upload of the resident plane (query packs, flat gather indices, mirror refreshes) comes through here
    return torch.from_numpy(np.ascontiguousarray(arr)).to(ds.device)


def _d2_flat_res(ds, ra: np.ndarray, rb: np.ndarray, gg: np.ndarray,
                 anch32: np.ndarray) -> torch.Tensor:
    """Enqueue one flat resident-pair distance gather.  Anchors are
    gathered per element on the host.  Returns the [T] float32 device
    tensor; the caller blocks on it at its stage's block point.  Every
    element ships as it is (no padding bucket), so the flat counters'
    ``bucket_elems`` equals ``elems``."""
    obs.note_flat_dispatch("res", len(ra), len(ra))
    av = np.ascontiguousarray(anch32[gg], dtype=np.float32)
    return kernel_ops.pairwise_d2_flat_res(
        ds.points_res, _to_dev(ds, ra), _to_dev(ds, rb), _to_dev(ds, av))


STAGES = ("predict", "cores", "edges", "border")


def _note_route(ds, stage: str, route: str, t0: float) -> None:
    """Count one run of ``stage`` by ``route`` (``"flat"``: a flat
    gather was enqueued on the resident tensors; ``"host_twin"``: the
    gate sent the whole stage to its host float64 twin) and add its
    wall seconds since ``t0``."""
    ds.stage_runs[stage][route] += 1
    ds.stage_s[stage][route] += time.perf_counter() - t0


class _Timer:
    """Accumulates pack vs kernel seconds into a ctr/stats dict."""

    def __init__(self, ctr: Optional[Dict[str, Any]]):
        self.ctr = ctr if ctr is not None else {}
        self.t0 = time.perf_counter()

    def mark(self, key: str) -> None:
        now = time.perf_counter()
        self.ctr[key] = self.ctr.get(key, 0.0) + (now - self.t0)
        self.t0 = now


# --------------------------------------------------------------------------
# the resident state
# --------------------------------------------------------------------------

class DeviceState:
    """Resident mirror of a fitted index's serving-hot arrays.

    Host numpy stays authoritative (snapshots never read device
    tensors); the mirror exists to feed the device gather indices
    instead of coordinates and is pinned to the host arrays by
    :meth:`mirror_matches` in the differential suite.  ``device=None``
    is the CUDA device (``RuntimeError`` when there is none).
    """

    def __init__(self, index, device=None):
        self.device = resolve_device(device)
        self.caps = ResidentCaps()
        self.uploads = 0          # full/structural buffer ships
        self.in_place = 0         # in-place flag updates (index_fill_)
        # per stage: runs that enqueued a flat gather vs runs the gate
        # sent to the host twin, and the seconds of each (the mutation
        # stats' t_pack / t_kernel lump both routes together)
        self.stage_runs = {s: {"flat": 0, "host_twin": 0} for s in STAGES}
        self.stage_s = {s: {"flat": 0.0, "host_twin": 0.0} for s in STAGES}
        pts = index.points
        self.origin = ((pts.min(axis=0) + pts.max(axis=0)) / 2.0
                       if len(pts) else np.zeros(index.d))
        self.span = 0.0           # monotone max |coord - origin|
        self.refresh_rows(index)
        self.refresh_small(index)

    # -- error band --------------------------------------------------------

    def note_batch(self, arr: np.ndarray) -> None:
        """Fold a coordinate batch (inserts *and* queries) into the
        span the error band is derived from -- monotone, so a certainty
        proven now stays valid for every earlier resident point."""
        if len(arr):
            self.span = max(self.span,
                            float(np.abs(np.asarray(arr, np.float64)
                                         - self.origin[None, :]).max()))

    def thresholds(self, index):
        """(band, lo2, hi2): the relative guard band and the certain
        hit / certain miss d2 thresholds around ``eps^2``."""
        d, eps = index.d, index.eps
        band = (_BAND_SAFETY * math.sqrt(d) * (d + 1)
                * max(self.span / eps, 1.0) * 2.0 ** -24)
        eps2 = eps * eps
        return band, eps2 * max(1.0 - band, 0.0), eps2 * (1.0 + band)

    # -- buffer lifecycle --------------------------------------------------

    def refresh_rows(self, index) -> None:
        """Structural re-upload of the row buffers (fit, splice,
        compact, cap growth): fresh tensors, old ones dropped."""
        n = index.n
        e = (len(index.merge_edges)
             if index.merge_edges is not None else 0)
        self.caps, _ = self.caps.grown_to(
            ResidentCaps.for_state(n, index.num_grids, e))
        rc = self.caps.row_cap
        p32 = np.zeros((rc, index.d), np.float32)
        p32[:n] = (index.points - self.origin[None, :]).astype(np.float32)
        self.note_batch(index.points)
        alive = np.zeros(rc, bool)
        alive[:n] = index.alive
        core = np.zeros(rc, bool)
        core[:n] = index.core
        self.points_res = _to_dev(self, p32)
        self.alive_res = _to_dev(self, alive)
        self.core_res = _to_dev(self, core)
        self.uploads += 1
        obs.counter("device_state.uploads.rows").inc()

    def refresh_small(self, index) -> None:
        """Re-ship the CSR / merge-edge mirrors (cheap, per mutation)."""
        G = index.num_grids
        e = (len(index.merge_edges)
             if index.merge_edges is not None else 0)
        self.caps, _ = self.caps.grown_to(
            ResidentCaps.for_state(index.n, G, e))
        gc, ec = self.caps.grid_cap, self.caps.edge_cap
        starts = np.zeros(gc, np.int32)
        counts = np.zeros(gc, np.int32)
        live = np.zeros(gc, np.int32)
        starts[:G] = index.starts
        counts[:G] = index.counts
        live[:G] = index.live_counts
        edges = np.full((ec, 2), -1, np.int32)
        if e:
            edges[:e] = index.merge_edges
        self.starts_res = _to_dev(self, starts)
        self.counts_res = _to_dev(self, counts)
        self.live_counts_res = _to_dev(self, live)
        self.merge_edges_res = _to_dev(self, edges)
        self.n_edges = e
        self.uploads += 1
        obs.counter("device_state.uploads.small").inc()

    def mark_dead(self, rows: np.ndarray) -> None:
        """In-place tombstone of resident rows (delete stage 1)."""
        if len(rows) == 0:
            return
        idx = _to_dev(self, np.asarray(rows, np.int64))
        self.alive_res.index_fill_(0, idx, False)
        self.core_res.index_fill_(0, idx, False)
        self.in_place += 1
        obs.counter("device_state.donations").inc()

    def flip_core(self, rows: np.ndarray, value: bool) -> None:
        """In-place core-flag update (core recompute flips)."""
        if len(rows) == 0:
            return
        idx = _to_dev(self, np.asarray(rows, np.int64))
        self.core_res.index_fill_(0, idx, bool(value))
        self.in_place += 1
        obs.counter("device_state.donations").inc()

    # -- differential pinning ---------------------------------------------

    def mirror_matches(self, index) -> Dict[str, bool]:
        """Per-buffer equality of the resident mirror against the host
        arrays -- what the stress tests assert after every mutation (a
        missed in-place update shows up here immediately)."""
        n, G = index.n, index.num_grids
        e = (len(index.merge_edges)
             if index.merge_edges is not None else 0)
        want32 = (index.points - self.origin[None, :]).astype(np.float32)

        def host(t):
            return t.cpu().numpy()

        me = host(self.merge_edges_res[:e]) if e else \
            np.zeros((0, 2), np.int32)
        host_e = (index.merge_edges if e else np.zeros((0, 2), np.int64))
        return {
            "points": np.array_equal(host(self.points_res[:n]), want32),
            "alive": np.array_equal(host(self.alive_res[:n]), index.alive),
            "alive_pad": bool(not host(self.alive_res[n:]).any()),
            "core": np.array_equal(host(self.core_res[:n]), index.core),
            "starts": np.array_equal(host(self.starts_res[:G]),
                                     index.starts.astype(np.int32)),
            "counts": np.array_equal(host(self.counts_res[:G]),
                                     index.counts.astype(np.int32)),
            "live_counts": np.array_equal(
                host(self.live_counts_res[:G]),
                index.live_counts.astype(np.int32)),
            "merge_edges": np.array_equal(me, host_e.astype(np.int32)),
        }


# --------------------------------------------------------------------------
# stage: predict
# --------------------------------------------------------------------------

def _anchors(index, ds, rep_ids: np.ndarray) -> np.ndarray:
    """float32 cell anchors relative to the resident origin (float64
    subtract, then cast -- the kernel sees stencil-scale coordinates)."""
    a = (index.mins[None, :]
         + (rep_ids - index.id_shift[None, :]) * index.side
         - ds.origin[None, :])
    return a.astype(np.float32)


def predict_device_async(index, ds, q: np.ndarray,
                         stats: Optional[dict]):
    """Two-phase device predict: pack + enqueue the distance gather
    now, return a resolver that blocks on it and finishes the labels.

    The split lets a serving loop pack the next batch on the host while
    this one's distances compute on the device.  ``resolve()`` returns
    ``(labels, d2)`` bit-identical to ``GritIndex._predict_host``.
    """
    tm = _Timer(stats)
    eps2 = index.eps * index.eps
    m = q.shape[0]
    ds.note_batch(q)
    band, _, _ = ds.thresholds(index)
    out = np.full(m, -1, np.int64)
    out_d2 = np.full(m, np.inf, np.float64)
    q_ids = index.query_ids(q)
    qorder, sq, gstart, gcount, _ = group_rows(q_ids)
    rep_ids = sq[gstart]
    B = len(gstart)
    rows, g_of = index._candidate_cores(rep_ids)
    cand_per = np.bincount(g_of, minlength=B).astype(np.int64)
    cand_offs = np.cumsum(cand_per) - cand_per
    nonempty = np.flatnonzero(cand_per > 0)
    if stats is not None:
        stats.update(groups=int(B), candidates=int(len(rows)),
                     chunks=0, uncertain=0)
    if len(nonempty) == 0:           # no candidates anywhere: all noise
        tm.mark("t_pack")
        return lambda: (out, out_d2)
    group_of = np.empty(m, np.int64)  # query position -> its group
    group_of[qorder] = np.repeat(np.arange(B), gcount)
    anch32 = _anchors(index, ds, rep_ids)
    q32 = (q - ds.origin[None, :]).astype(np.float32)
    # flat ragged layout: each query's candidate segment, replicated in
    # host candidate order, one gather for the whole batch (zero padding
    # waste).  queries are not resident: center on host in f32 (IEEE --
    # identical values to the device-side subtract on the b side)
    qa = q32 - anch32[group_of]
    csz = cand_per[group_of]                      # candidates per query
    offs = cand_offs[group_of]
    T = int(csz.sum())
    rr_flat = rows[_expand(offs, csz)]
    qo_flat = np.repeat(np.arange(m), csz)        # sorted segment ids
    av = np.repeat(anch32[group_of], csz, axis=0)  # per-element anchors
    obs.note_flat_dispatch("predict", T, T)
    d2dev = kernel_ops.pairwise_d2_flat(
        ds.points_res, _to_dev(ds, qa), _to_dev(ds, rr_flat),
        _to_dev(ds, qo_flat), _to_dev(ds, av))
    if stats is not None:
        stats["chunks"] = 1
    pack_s = time.perf_counter() - tm.t0
    tm.mark("t_pack")

    def resolve():
        tm.t0 = time.perf_counter()
        t_route = tm.t0 - pack_s
        # grit-lint: disable=hot-path-sync -- resolve() IS this stage's single intended block point: f32 distances materialize once here
        d2f = d2dev.cpu().numpy()                 # f32, device math
        # segmented (min, first-arg, runner-up) on host: one C pass
        # per reduce, same shape as the host oracle's reduceat
        hasq = np.flatnonzero(csz > 0)
        seg = (np.cumsum(csz) - csz)[hasq]
        mn_h = np.minimum.reduceat(d2f, seg)
        is_min = d2f == np.repeat(mn_h, csz[hasq])
        pos = np.flatnonzero(is_min)
        _, first = np.unique(qo_flat[pos], return_index=True)
        best = pos[first]                         # first-min tie-break
        d2b = d2f.copy()
        d2b[best] = np.inf                        # drop argmin element
        mn2_h = np.minimum.reduceat(d2b, seg)
        mn = np.full(m, np.inf)
        mn[hasq] = mn_h.astype(np.float64)
        mn2 = np.full(m, np.inf)
        mn2[hasq] = mn2_h.astype(np.float64)
        ag = np.full(m, -1, np.int64)
        ag[hasq] = best
        with np.errstate(invalid="ignore"):     # inf - inf rows
            cert = (np.isinf(mn2)
                    | (mn2 - mn > 2.0 * band * eps2)) & (ag >= 0)
        qp = np.flatnonzero(cert)
        if len(qp):
            rr = rr_flat[ag[qp]]
            d2v = ((index.points[rr] - q[qp]) ** 2).sum(axis=1)
            out_d2[qp] = d2v
            hit = d2v <= eps2
            out[qp[hit]] = index.labels[rr[hit]]
        unc = np.flatnonzero((csz > 0) & ~cert)
        if len(unc):
            # band fallback, targeted: a query's flat candidate segment
            # IS its host candidate list (same cell id -> same
            # ``_candidate_cores`` order), so re-deriving the f64
            # segmented argmin over it -- first-hit tie-break, same
            # expression -- equals ``_predict_host`` bit for bit
            # without re-walking the tree for the uncertain subset.
            cs = csz[unc]
            seg = np.cumsum(cs) - cs
            rrq = rows[_expand(offs[unc], cs)]
            qof = np.repeat(np.arange(len(unc)), cs)
            d2v = ((index.points[rrq] - q[unc][qof]) ** 2).sum(axis=1)
            dmin = np.minimum.reduceat(d2v, seg)
            is_min = d2v == np.repeat(dmin, cs)
            pos = np.flatnonzero(is_min)
            qpos_u, first = np.unique(qof[pos], return_index=True)
            best = pos[first]
            out_d2[unc[qpos_u]] = d2v[best]
            hit = d2v[best] <= eps2
            out[unc[qpos_u[hit]]] = index.labels[rrq[best[hit]]]
            if stats is not None:
                stats["uncertain"] = int(len(unc))
        tm.mark("t_kernel")
        _note_route(ds, "predict", "flat", t_route)
        return out, out_d2

    return resolve


def predict_device(index, ds, q: np.ndarray, stats: Optional[dict]):
    return predict_device_async(index, ds, q, stats)()


# --------------------------------------------------------------------------
# stage: core recompute (delta stage 2)
# --------------------------------------------------------------------------

def recompute_cores_device(index, ds, affected: np.ndarray,
                           direction: int,
                           ctr: Dict[str, Any]) -> np.ndarray:
    """Device twin of ``delta._recompute_cores_host``: identical need
    filter, shortcut, and flip set (bit-identical ``newly_core`` /
    ``demoted`` arrays), with the per-grid count loops replaced by one
    flat ``pairwise_d2_flat_res`` dispatch and segmented host counts."""
    tm = _Timer(ctr)
    t_start = tm.t0
    pts, core, alive = index.points, index.core, index.alive
    starts, counts = index.starts, index.counts
    live_counts, min_pts = index.live_counts, index.min_pts
    eps2 = index.eps * index.eps
    band, lo2, hi2 = ds.thresholds(index)
    ccnt = _core_count_per_grid(index)
    if direction > 0:
        need = affected[live_counts[affected] > ccnt[affected]]
    else:
        need = affected[(live_counts[affected] < min_pts)
                        & (ccnt[affected] > 0)]
    if len(need) == 0:
        tm.mark("t_pack")
        return np.empty(0, np.int64)
    ip, nb, _ = index.tree.query(index.ids[need], include_self=False)
    K = len(need)
    # gate on a cheap upper bound of the flat element count (dead rows
    # not yet filtered) *before* building any flat layout: a tiny
    # recount runs the host float64 twin outright -- upload + dispatch
    # overhead would exceed the f32 win, and the twin IS the reference,
    # so the shortcut cannot change any output.  The twin flips
    # ``index.core`` itself; only the resident flags need syncing.
    nbc = np.concatenate([[0], np.cumsum(counts[nb])])
    if int(counts[need] @ (nbc[ip[1:]] - nbc[ip[:-1]])) < MIN_FLAT_T:
        tm.mark("t_pack")
        flips = _recompute_cores_host(index, affected, direction, ctr)
        if len(flips):
            ds.flip_core(flips, direction > 0)
        tm.mark("t_kernel")
        _note_route(ds, "cores", "host_twin", t_start)
        return flips
    # flat candidate rows, grouped in need order (ascending within a
    # grid) -- the flip set reads out of this order, so it matches the
    # host loop's concatenation bit for bit
    own = _expand(starts[need], counts[need])
    own_g = np.repeat(np.arange(K), counts[need])
    keepm = alive[own]
    own, own_g = own[keepm], own_g[keepm]
    keepm = ~core[own] if direction > 0 else core[own]
    cand, cand_g = own[keepm], own_g[keepm]
    cand_sizes = np.bincount(cand_g, minlength=K)
    cand_offs = np.cumsum(cand_sizes) - cand_sizes
    flip = np.zeros(len(cand), bool)
    kern = np.arange(K)
    if direction > 0:
        short = live_counts[need] >= min_pts    # all-live-core shortcut
        flip[short[cand_g]] = True
        kern = np.flatnonzero(~short)
    # stencil candidate rows (live) per need grid
    nsz = np.diff(ip)
    n_of = np.repeat(np.arange(K), nsz)
    nrows = _expand(starts[nb], counts[nb])
    nrow_g = np.repeat(n_of, counts[nb])
    keepm = alive[nrows]
    nrows, nrow_g = nrows[keepm], nrow_g[keepm]
    nb_sizes = np.bincount(nrow_g, minlength=K)
    nb_offs = np.cumsum(nb_sizes) - nb_sizes
    # no live stencil candidate at all: the own count decides exactly
    zero = kern[nb_sizes[kern] == 0]
    if len(zero) and direction < 0:
        # need filter guarantees live_counts < MinPts here: demote all
        flip[np.isin(cand_g, zero)] = True
    kern = kern[(nb_sizes[kern] > 0) & (cand_sizes[kern] > 0)]
    base_of = live_counts[need]
    anch32 = _anchors(index, ds, index.ids[need])
    if len(kern):
        ra, rb, seg, row_pos, row_k = _row_cross(
            cand, cand_sizes, cand_offs, nrows, nb_sizes, nb_offs,
            kern)
        d2dev = _d2_flat_res(ds, ra, rb, np.repeat(kern[row_k], seg),
                             anch32)
    tm.mark("t_pack")

    unc_parts = []
    if len(kern):
        # grit-lint: disable=hot-path-sync -- the stage's single intended block point: bracketing counts need the f32 distances
        d2f = d2dev.cpu().numpy()
        # bracketing counts per candidate row: any f32 distance at or
        # under lo2 is provably a neighbor, anything over hi2 provably
        # is not (guard band, module docstring) -- one add.reduceat
        # pass each, same segmented shape as the host loop's counts
        soff = np.cumsum(seg) - seg
        clo = np.add.reduceat((d2f <= lo2).astype(np.int64), soff)
        chi = np.add.reduceat((d2f <= hi2).astype(np.int64), soff)
        base = base_of[kern[row_k]]
        is_core = base + clo >= min_pts
        not_core = base + chi < min_pts
        want = is_core if direction > 0 else not_core
        flip[row_pos[want]] = True
        unc = ~is_core & ~not_core
        if unc.any():
            unc_parts.append(row_pos[unc])
    if unc_parts:
        # exact float64 recount for the uncertain rows, one group at a
        # time against its own stencil candidates (the same candidate
        # set the host loop scans)
        up = np.concatenate(unc_parts)
        ctr["band_fallback"] = ctr.get("band_fallback", 0) + len(up)
        for g in np.unique(cand_g[up]):
            rr = cand[up[cand_g[up] == g]]
            nr = nrows[nb_offs[g]:nb_offs[g] + nb_sizes[g]]
            d2 = ((pts[rr][:, None, :] - pts[nr][None, :, :]) ** 2
                  ).sum(-1)
            ctr["dist_evals"] += d2.size
            cnt = base_of[g] + (d2 <= eps2).sum(1)
            dec = cnt >= min_pts if direction > 0 else cnt < min_pts
            flip[up[cand_g[up] == g]] = dec
    flips = cand[flip]
    if len(flips):
        core[flips] = direction > 0
        ds.flip_core(flips, direction > 0)
    tm.mark("t_kernel")
    if len(kern):
        _note_route(ds, "cores", "flat", t_start)
    return flips


# --------------------------------------------------------------------------
# stage: merge-edge decisions (delta stage 3)
# --------------------------------------------------------------------------

def decide_edges_device(index, ds, pairs: np.ndarray,
                        ctr: Dict[str, Any]) -> np.ndarray:
    """Device twin of ``delta._decide_edges_batch``: same exact bbox
    reject, then the pair minima come from one flat
    ``pairwise_d2_flat_res`` dispatch reduced per pair; the
    band-uncertain pairs re-run the host float64 decision."""
    if len(pairs) == 0:
        return np.zeros(0, bool)
    tm = _Timer(ctr)
    t_start = tm.t0
    band, lo2, hi2 = ds.thresholds(index)
    hit = np.zeros(len(pairs), bool)
    rem = _bbox_survivors(index, pairs)
    if len(rem) == 0:
        tm.mark("t_pack")
        return hit
    core_rows, cstarts, ccounts = index._core_ranges()
    a, b = pairs[rem, 0], pairs[rem, 1]
    sizes_a, sizes_b = ccounts[a], ccounts[b]
    # a pair with no core on either side has pairmin inf: no edge,
    # certain (the host reduce over an empty set agrees)
    psel = np.flatnonzero((sizes_a > 0) & (sizes_b > 0))
    if int(sizes_a[psel] @ sizes_b[psel]) < EDGE_MIN_FLAT_T:
        # small decision batch: the host twin's per-pair early exit
        # beats the full-cross-product dispatch (gate before any flat
        # layout is built; same-output by construction)
        tm.mark("t_pack")
        hit[rem] = _decide_edges_batch(index, pairs[rem], ctr)
        tm.mark("t_kernel")
        _note_route(ds, "edges", "host_twin", t_start)
        return hit
    aflat = core_rows[_expand(cstarts[a], sizes_a)]
    bflat = core_rows[_expand(cstarts[b], sizes_b)]
    a_offs = np.cumsum(sizes_a) - sizes_a
    b_offs = np.cumsum(sizes_b) - sizes_b
    anch32 = _anchors(index, ds, index.ids[a])
    if len(psel):
        ra, rb, seg, _, row_k = _row_cross(
            aflat, sizes_a, a_offs, bflat, sizes_b, b_offs, psel)
        d2dev = _d2_flat_res(ds, ra, rb, np.repeat(psel[row_k], seg),
                             anch32)
    tm.mark("t_pack")
    unc = np.empty(0, np.int64)
    if len(psel):
        # grit-lint: disable=hot-path-sync -- the stage's single intended block point: pair minima resolve from f32 distances
        d2f = d2dev.cpu().numpy()
        soff = np.cumsum(seg) - seg
        rowmin = np.minimum.reduceat(d2f, soff).astype(np.float64)
        # pair min = min over its a rows' segment minima
        rps = np.bincount(row_k, minlength=len(psel))
        poff = np.cumsum(rps) - rps
        pairmin = np.minimum.reduceat(rowmin, poff)
        hit[rem[psel[pairmin <= lo2]]] = True
        unc = psel[(pairmin > lo2) & (pairmin <= hi2)]
    if len(unc):
        ctr["band_fallback"] = ctr.get("band_fallback", 0) + len(unc)
        hit[rem[unc]] = _decide_edges_batch(index, pairs[rem[unc]], ctr)
    tm.mark("t_kernel")
    if len(psel):
        _note_route(ds, "edges", "flat", t_start)
    return hit


# --------------------------------------------------------------------------
# stage: border pass (delta stage 5)
# --------------------------------------------------------------------------

def border_pass_device(index, ds, rows: np.ndarray,
                       grid_of: np.ndarray,
                       ctr: Dict[str, Any]) -> None:
    """Device twin of ``delta._border_pass_host``: nearest-live-core
    via one flat ``pairwise_d2_flat_res`` dispatch and a segmented
    (min, first-arg, runner-up) host reduce; a row is decided only
    when its argmin is certain (runner-up gap above the band), and its
    winning distance is re-derived in float64 -- the emitted label is
    the host label.  Uncertain rows re-run the host pass."""
    if len(rows) == 0:
        return
    tm = _Timer(ctr)
    t_start = tm.t0
    pts, lab = index.points, index.labels
    eps2 = index.eps * index.eps
    band, _, _ = ds.thresholds(index)
    lab[rows] = -1
    cgrids = np.unique(grid_of[rows])
    ip, nb, _ = index.tree.query(index.ids[cgrids], include_self=False)
    K = len(cgrids)
    rg = np.searchsorted(cgrids, grid_of[rows])     # rows sorted ->
    sizes_a = np.bincount(rg, minlength=K)          # groups contiguous
    a_offs = np.cumsum(sizes_a) - sizes_a
    # own + stencil grids per group, own first (host concat order)
    nsz = np.diff(ip)
    gsz = 1 + nsz
    g_offs = np.cumsum(gsz) - gsz
    gflat = np.empty(int(gsz.sum()), np.int64)
    gflat[g_offs] = cgrids
    mask = np.ones(len(gflat), bool)
    mask[g_offs] = False
    gflat[mask] = nb
    g_of2 = np.repeat(np.arange(K), gsz)
    core_rows, cstarts, ccounts = index._core_ranges()
    # gate before the flat candidate build: per-group core totals come
    # from one cumsum over the (cheap) per-grid core counts
    gcc = np.concatenate([[0], np.cumsum(ccounts[gflat])])
    sizes_b = gcc[g_offs + gsz] - gcc[g_offs]
    if int(sizes_a @ sizes_b) < MIN_FLAT_T:
        # tiny border batch: host twin beats dispatch overhead
        tm.mark("t_pack")
        _border_pass_host(index, rows, grid_of, ctr)
        tm.mark("t_kernel")
        _note_route(ds, "border", "host_twin", t_start)
        return
    crows = core_rows[_expand(cstarts[gflat], ccounts[gflat])]
    b_offs = np.cumsum(sizes_b) - sizes_b
    kern = np.flatnonzero((sizes_b > 0) & (sizes_a > 0))
    # groups with no core candidate: rows stay noise (host `continue`)
    anch32 = _anchors(index, ds, index.ids[cgrids])
    if len(kern):
        ra, rb, seg, _, row_k = _row_cross(
            rows, sizes_a, a_offs, crows, sizes_b, b_offs, kern)
        d2dev = _d2_flat_res(ds, ra, rb, np.repeat(kern[row_k], seg),
                             anch32)
    tm.mark("t_pack")
    unc = np.empty(0, np.int64)
    if len(kern):
        # grit-lint: disable=hot-path-sync -- the stage's single intended block point: border assignment needs segment minima
        d2f = d2dev.cpu().numpy()
        soff = np.cumsum(seg) - seg
        nrow = len(soff)
        mn_f = np.minimum.reduceat(d2f, soff)
        # first flat index achieving each segment min (candidate order
        # is own-first host order, so ties break like the host pass)
        is_min = d2f == np.repeat(mn_f, seg)
        pos = np.flatnonzero(is_min)
        segid = np.repeat(np.arange(nrow), seg)
        _, first = np.unique(segid[pos], return_index=True)
        best = pos[first]
        d2b = d2f.copy()
        d2b[best] = np.inf                  # runner-up sans argmin
        mn2_f = np.minimum.reduceat(d2b, soff)
        mn = mn_f.astype(np.float64)
        mn2 = mn2_f.astype(np.float64)
        rvals = ra[best]                    # == the segment's a row
        with np.errstate(invalid="ignore"):         # inf - inf rows
            cert = np.isinf(mn2) | (mn2 - mn > 2.0 * band * eps2)
        if cert.any():
            rr = rvals[cert]
            cc = rb[best[cert]]
            d2v = ((pts[rr] - pts[cc]) ** 2).sum(axis=1)
            okh = d2v <= eps2
            lab[rr[okh]] = lab[cc[okh]]
        unc = rvals[~cert]
    if len(unc):
        unc = np.unique(unc)
        ctr["band_fallback"] = ctr.get("band_fallback", 0) + len(unc)
        _border_pass_host(index, unc, grid_of, ctr)
    tm.mark("t_kernel")
    if len(kern):
        _note_route(ds, "border", "flat", t_start)
