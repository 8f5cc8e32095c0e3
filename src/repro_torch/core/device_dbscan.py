"""GriT-DBSCAN on the device (torch tensors, static shape caps).

The whole of Algorithm 6 as one function over tensors that live where
``points`` lives:

  grids (Alg 1, stable multi-key sort)   -> ``grids.build_grids_device``
  grid-tree neighbor query (Alg 3)       -> ``grid_tree.device_neighbor_table``
  core identification (G13 + all-core shortcut, offset-sorted candidates)
  FastMerging over core-grid pairs (Alg 5, masked)
  connected components (pointer jumping)
  border / noise assignment

Static caps stand in for the dynamic data structures of the paper;
every cap has an ``overflow`` flag so a caller can retry with larger
caps.  torch would allow dynamic shapes, but the caps and their per-cap
overflow semantics are kept exactly: they are what the stage tables are
compared on, table by table, against ``repro.core.device_dbscan``.

``GritCaps.packed`` (default True) selects *occupancy-packed* dispatch
for the cap-proportional stages.  The dense strategy sweeps
``core_rows`` / ``border_rows`` over every ``grid_cap`` slot at the full
``c_cap`` width.  The packed
strategy keeps the paper's work-proportional claim: live small grids
are compacted to a prefix sorted by candidate total and swept in three
tiers at pow2 sub-caps (``c_cap/4``, ``c_cap/2``, ``c_cap``), the widest
tier doubling as the dense-tail path for the few heavy grids.  Outputs
are identical to the dense path: a grid in a tier has candidate total
<= the tier width, so no candidate is truncated, the per-row distance
rows are elementwise the same values, and the result scatters (max for
core flags, min for border labels) are order-independent.  Overflow
flags are computed from the global per-grid candidate totals, never
from what a tier dispatched.  The tier bounds are data dependent and
are read to the host once per fit.  The border sweep visits only the
grids of each tier that hold a non-core point (a grid of core points
assigns no border label; one more host read), so ``dispatch_tiers``
counts the core sweep's grids.

Chunking: ``grid_block`` / ``pair_block`` are validated and carried for
compatibility of the caps, but they are memory chunking, not semantics
(every row and every pair is independent, ``dispatch_tiers`` counts
grids, not blocks).  This module sweeps chunks sized from a memory
budget instead (``SWEEP_ELEMS``, ``PLAIN_ELEMS``, ``MERGE_ELEMS``), and
the merge stage visits only the prefix of valid pairs in either
dispatch mode: the slots past it are all-False rows of ``merged``.  It
sweeps the pairs in width tiers, each pair's point sets padded to the
power of two at or above its grids' larger occupancy (at most
``m_cap``): the same decisions as at ``m_cap``, at the work of the
pair's own sizes (one host read of the tier bounds).

``GritCaps.use_kernels`` selects the distance plane for the two
distance-heavy stages.  ``False`` is the plain broadcast plane -- the
in-pipeline oracle (engine ``device``).  ``True`` routes ``core_rows``
through ``kernels.ops.eps_count_batch`` and ``border_rows`` through
``kernels.ops.row_min_batch``: the CUDA kernels on the card, their
plain versions for CPU tensors.  Before a kernel call both point sets
are re-centered on the grid's first own point: candidates live within
the neighbor stencil (a few eps), so the float32 differences are taken
on stencil-scale coordinates.  The overflow flags are computed from
candidate totals, never from distance values, so the plane leaves the
``OverflowReport`` untouched.

Padding convention: invalid points are moved to ``PAD_COORD`` so they
land in (ignorable) far-away grids and never satisfy a distance
predicate.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch

from .grids import build_grids_device, DeviceGrids
from .grid_tree import device_neighbor_table
from .merging import fast_merging_batch
from .labels import label_propagation
from .sync import SPANS, count_read, host_read, stage_mark, stage_start
from ..kernels import ops as kernel_ops

PAD_COORD = 1e15

# elements of one [grids, width] candidate table per sweep chunk
SWEEP_ELEMS = 1 << 23
# elements of one [grids, P, width] distance tensor of the plain plane
PLAIN_ELEMS = 1 << 25
# elements of one [pairs, m_cap, d] point-set tensor of the merge stage
MERGE_ELEMS = 1 << 25


@dataclasses.dataclass
class OverflowReport:
    """Per-cap overflow flags (0-d bool tensors, or Python bools once
    read to the host).

    Each flag names the ``GritCaps`` field that was exceeded, so a
    caller can grow exactly the caps that overflowed instead of blindly
    scaling everything.  When a flag fires the result is a *subset*
    (silently truncated) and must not be trusted.
    """

    grid: object         # grid_cap: non-empty grids truncated
    frontier: object     # frontier_cap: grid-tree level frontier
    neighbors: object    # k_cap: neighbor grids per grid
    candidates: object   # c_cap: candidate points per small grid
    core_set: object     # m_cap: core points per grid (merging)
    pairs: object        # pair_cap: core-grid merge pairs
    halo: object         # halo_cap: distributed boundary exchange

    FIELDS: ClassVar[Tuple[str, ...]] = (
        "grid", "frontier", "neighbors", "candidates", "core_set",
        "pairs", "halo")

    @classmethod
    def from_vector(cls, vec) -> "OverflowReport":
        assert len(vec) == len(cls.FIELDS)
        return cls(*(vec[i] for i in range(len(cls.FIELDS))))

    def as_vector(self) -> torch.Tensor:
        return torch.stack([torch.as_tensor(getattr(self, f)).to(torch.bool)
                            for f in self.FIELDS])

    def any(self) -> torch.Tensor:
        flags = self.as_vector()
        return flags.any()

    def overflowing(self) -> Tuple[str, ...]:
        """Host-side: names of the caps that overflowed."""
        return tuple(f for f in self.FIELDS if bool(getattr(self, f)))

    def __bool__(self) -> bool:
        return bool(self.any())


@dataclasses.dataclass(frozen=True)
class GritCaps:
    """Static shape caps + execution strategy for the device pipeline.

    ``use_kernels`` rides along with the caps: True routes the
    core/border distance plane through the batched kernels instead of
    the plain broadcast tensor.
    """

    grid_cap: int = 1024       # max non-empty grids
    frontier_cap: int = 128    # grid-tree per-level frontier
    k_cap: int = 48            # neighbors per grid
    c_cap: int = 512           # candidate points per grid (self + neighbors)
    m_cap: int = 64            # core points per grid used by merging
    pair_cap: int = 4096       # merge pairs
    grid_block: int = 128      # carried for cap compatibility (module doc)
    pair_block: int = 512      # carried for cap compatibility (module doc)
    merge_iters: int = 64      # FastMerging max iterations (paper kappa<=11)
    use_kernels: bool = False  # kernelized distance plane (see module doc)
    packed: bool = True        # occupancy-packed dispatch (see module doc)

    def __post_init__(self):
        if self.grid_block <= 0 or self.grid_cap % self.grid_block != 0:
            raise ValueError(
                f"grid_cap ({self.grid_cap}) must be a positive multiple "
                f"of grid_block ({self.grid_block})")
        if self.pair_block <= 0 or self.pair_cap % self.pair_block != 0:
            raise ValueError(
                f"pair_cap ({self.pair_cap}) must be a positive multiple "
                f"of pair_block ({self.pair_block})")

    @classmethod
    def for_dim(cls, d: int, **kw) -> "GritCaps":
        """Caps with the frontier sized to the paper's per-level fanout
        bound (2*ceil(sqrt(d))+1)^(d-1).  Overflow flags still guard
        correctness if data exceeds any cap."""
        import math
        r = 2 * math.ceil(math.sqrt(d)) + 1
        frontier = int(min(r ** max(d - 1, 1), 256))
        kw.setdefault("frontier_cap", max(frontier, 8))
        kw.setdefault("merge_iters", 16)   # paper Remark 3: kappa <= 11
        return cls(**kw)


@dataclasses.dataclass
class DeviceDBSCANResult:
    labels: torch.Tensor       # [n] int32, original order; -1 noise
    core: torch.Tensor         # [n] bool, original order
    point_grid: torch.Tensor   # [n] int32 grid row of each point, original
                               # order (rows of the device grid table; f32
                               # identifiers -- provenance, not a float64
                               # host partition)
    num_clusters: torch.Tensor  # [] int32
    overflow: torch.Tensor     # [] bool -- any static cap exceeded
    report: OverflowReport     # which cap(s) overflowed
    dispatch_tiers: torch.Tensor  # [4] int32 dispatch telemetry: grids
                               # swept by the three packed occupancy
                               # tiers (c_cap/4, c_cap/2, c_cap) and, in
                               # slot 3, the dense-path grid slots (0
                               # when packed); their sum is the total
                               # dispatched grid work
    tier_counts: Tuple[int, ...] = (0, 0, 0, 0)  # the same four counts
                               # as host ints (known to the host when it
                               # cut the sweeps; read by the gauges)


def _candidates_for_grids(dg: DeviceGrids, nbr: torch.Tensor,
                          gsel: torch.Tensor, c_cap: int):
    """Candidate point indices for each grid in ``gsel``: own grid first,
    then neighbors in offset-ascending order (paper's early-exit order).

    ``nbr`` is the int64 neighbor table, ``gsel`` int64 grid rows.
    Returns (cand_idx [B, c_cap] into sorted points, cand_grid [B, c_cap],
    cand_valid [B, c_cap], cand_total [B])."""
    B = gsel.shape[0]
    K = nbr.shape[1]
    dev = gsel.device
    counts = dg.counts.to(torch.int64)
    starts = dg.starts.to(torch.int64)
    cg = torch.cat([gsel[:, None], nbr[gsel]], dim=1)              # [B, K+1]
    cg_valid = cg >= 0
    cgc = torch.where(cg_valid, cg, torch.zeros_like(cg))
    sizes = torch.where(cg_valid, counts[cgc], torch.zeros_like(cg))
    cum = torch.cumsum(sizes, dim=1)                               # inclusive
    total = cum[:, -1]
    slots = torch.arange(c_cap, device=dev)[None, :].expand(B, c_cap)
    # segment of each slot: first seg with cum > slot
    seg = torch.searchsorted(cum, slots.contiguous(), right=True)
    seg = torch.clamp_max(seg, K)
    prev = torch.where(seg > 0,
                       torch.gather(cum, 1, torch.clamp_min(seg - 1, 0)),
                       torch.zeros_like(seg))
    within = slots - prev
    g_of = torch.gather(cgc, 1, seg)
    idx = starts[g_of] + within
    valid = slots < total[:, None]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, g_of, valid, total


def device_dbscan(points: torch.Tensor, eps: float, min_pts: int,
                  caps: GritCaps,
                  point_valid: Optional[torch.Tensor] = None
                  ) -> DeviceDBSCANResult:
    """Exact GriT-DBSCAN on the device of ``points`` ([n, d] float32).
    Labels in original point order."""
    try:
        return _pipeline(points, eps, min_pts, caps, point_valid)
    finally:
        SPANS.close()    # the stage span an error left open


def _pipeline(points: torch.Tensor, eps: float, min_pts: int,
              caps: GritCaps, point_valid: Optional[torch.Tensor]
              ) -> DeviceDBSCANResult:
    n, d = points.shape
    dev = points.device
    eps = float(eps)
    eps_t = torch.tensor(eps, dtype=points.dtype, device=dev)
    eps2 = eps_t * eps_t
    if point_valid is None:
        point_valid = torch.ones((n,), dtype=torch.bool, device=dev)
    pts = torch.where(point_valid[:, None], points,
                      torch.full_like(points, PAD_COORD))
    stage_start(dev)

    # ---- step 1: grids + grid tree neighbors --------------------------
    dg = build_grids_device(pts, eps, caps.grid_cap)
    stage_mark("grids", dev)
    nbr32, _, ovf_frontier, ovf_k = device_neighbor_table(
        dg.ids, dg.num_grids, frontier_cap=caps.frontier_cap,
        k_cap=caps.k_cap, include_self=False)
    nbr = nbr32.to(torch.int64)
    stage_mark("neighbors", dev)
    G = caps.grid_cap
    K = caps.k_cap
    grid_rows = torch.arange(G, device=dev)
    live = grid_rows < dg.num_grids
    order = dg.order.to(torch.int64)
    point_grid = dg.point_grid.to(torch.int64)
    starts = dg.starts.to(torch.int64)
    counts = dg.counts.to(torch.int64)
    sorted_valid = point_valid[order]
    spts = dg.sorted_points

    # ---- step 2: core points ------------------------------------------
    # all-core shortcut: grids with >= MinPts (valid) points
    valid_counts = torch.zeros((G,), dtype=torch.int64, device=dev)
    valid_counts.index_add_(0, point_grid, sorted_valid.to(torch.int64))
    big = (valid_counts >= min_pts) & live
    core_flag = (big[point_grid] & sorted_valid).to(torch.int32)
    # grids holding only padding points (all invalid points share
    # PAD_COORD, so they land in grids of their own) need no core scan
    # and must not count against c_cap
    occupied = live & (valid_counts > 0)

    p_cap = max(min_pts - 1, 1)
    own_slot = torch.arange(p_cap, device=dev)[None, :]

    def grid_anchor(gsel):
        """First own point of each selected grid: the re-centering origin
        for the kernelized distance plane (module docstring)."""
        return spts[torch.clamp_max(starts[gsel], n - 1)][:, None, :]

    # per-grid candidate totals (own + neighbor occupancies): the same
    # numbers _candidates_for_grids derives per chunk, computed once for
    # every grid -- they drive the candidates overflow flag and, under
    # packed dispatch, the occupancy-tier assignment
    total_all = counts + torch.where(
        nbr >= 0, counts[torch.clamp_min(nbr, 0)],
        torch.zeros_like(nbr)).sum(dim=1)
    small_all = (~big) & occupied
    ovf_candidates = ((total_all > caps.c_cap) & small_all).any()

    def own_rows(gsel):
        own_idx = starts[gsel][:, None] + own_slot
        small = (~big[gsel]) & occupied[gsel]
        own_valid = (own_slot < counts[gsel][:, None]) & small[:, None]
        return torch.where(own_valid, own_idx,
                           torch.zeros_like(own_idx)), own_valid

    def core_rows(gsel, width):
        """Core test of one grid chunk at candidate width ``width``:
        identical values to the full-width pass for any grid whose
        candidate total fits (no truncation, same candidate prefix
        order, same distance rows)."""
        cand_idx, _, cand_valid, _ = _candidates_for_grids(
            dg, nbr, gsel, width)
        cand_valid = cand_valid & sorted_valid[cand_idx]
        own_idx, own_valid = own_rows(gsel)
        a = spts[own_idx]                       # [B, P, d]
        b = spts[cand_idx]                      # [B, C, d]
        if caps.use_kernels:
            # stop_at=min_pts: the saturating-count contract -- exact
            # below min_pts, ">= min_pts" above -- is all the core test
            # needs, and it unlocks the paper's offset-ascending early
            # exit (candidates are already in that order)
            anchor = grid_anchor(gsel)
            cnt = kernel_ops.eps_count_batch(a - anchor, b - anchor, eps,
                                             valid_b=cand_valid,
                                             valid_a=own_valid,
                                             stop_at=min_pts)
        else:
            hit = (kernel_ops.sq_dists_direct(a, b) <= eps2) & cand_valid[:, None, :]
            cnt = hit.sum(dim=2)
        return own_idx, (cnt >= min_pts) & own_valid

    def chunk_rows(width):
        if caps.use_kernels:
            return max(1, SWEEP_ELEMS // width)
        return max(1, PLAIN_ELEMS // (width * p_cap))

    if caps.packed:
        # occupancy-packed dispatch: live small grids compacted to a
        # prefix sorted by candidate total (stable, so equal totals keep
        # grid order), swept tier by tier at pow2 sub-caps.  A grid's
        # tier width bounds its candidate total, so every tier sees the
        # exact candidate set; grids whose total exceeds c_cap run (and
        # truncate) in the widest tier exactly as the dense path does,
        # with the candidates flag raised from total_all above.
        tier_w = sorted({max(8, caps.c_cap // 4),
                         max(8, caps.c_cap // 2), caps.c_cap})
        pperm = torch.argsort(
            torch.where(small_all, total_all,
                        torch.full_like(total_all, 2 ** 30)), stable=True)
        cuts = host_read(torch.stack(
            [(small_all & (total_all <= w)).sum() for w in tier_w[:-1]]
            + [small_all.sum()]))
        sweeps = [(pperm, lo, hi, w)
                  for lo, hi, w in zip([0] + cuts[:-1], cuts, tier_w)]
        swept = [hi - lo for _, lo, hi, _ in sweeps]
        tier_counts = tuple(swept + [0] * (4 - len(swept)))
    else:
        sweeps = [(grid_rows, 0, G, caps.c_cap)]
        tier_counts = (0, 0, 0, G)
    SPANS.set(tier_widths=[w for *_, w in sweeps],
              tier_grids=[hi - lo for _, lo, hi, _ in sweeps])
    dispatch_tiers = torch.tensor(tier_counts, dtype=torch.int32, device=dev)

    def sweep(row_fn, acc, reduce, plan):
        for rows_of, lo, hi, width in plan:
            step = chunk_rows(width)
            for s in range(lo, hi, step):
                oi, val = row_fn(rows_of[s:min(s + step, hi)], width)
                # duplicate indices (invalid rows all land on index 0
                # with the neutral value) reduce order-independently
                acc.scatter_reduce_(0, oi.reshape(-1),
                                    val.reshape(-1).to(acc.dtype), reduce,
                                    include_self=True)
        return acc

    core_sorted = sweep(core_rows, core_flag, "amax", sweeps) > 0
    stage_mark("core", dev)

    core_per_grid = torch.zeros((G,), dtype=torch.int64, device=dev)
    core_per_grid.index_add_(0, point_grid, core_sorted.to(torch.int64))
    core_grid = (core_per_grid > 0) & live
    ovf_core_set = (core_per_grid > caps.m_cap).any()

    # ---- step 3: merging -----------------------------------------------
    # pairs (g, g') with g' in Nei(g), both core, deduped by g' > g; the
    # valid ones in (g, neighbor slot) order, truncated at pair_cap
    pair_valid = ((nbr > grid_rows[:, None]) & core_grid[:, None]
                  & core_grid[torch.clamp_min(nbr, 0)])
    flat = torch.nonzero(pair_valid.reshape(-1))[:, 0]
    count_read()
    ovf_pairs = torch.tensor(flat.numel() > caps.pair_cap, device=dev)
    flat = flat[:caps.pair_cap]
    pg = torch.div(flat, K, rounding_mode="floor")
    ph = nbr.reshape(-1)[flat]

    def core_set(g, width):
        """Compacted core points of each grid in ``g`` among its first
        ``width`` points: (index into the sorted points [N, width],
        validity [N, width])."""
        slot = torch.arange(width, device=dev)[None, :]
        inb = slot < counts[g][:, None]
        pidx = torch.where(inb, starts[g][:, None] + slot,
                           torch.zeros_like(inb, dtype=torch.int64))
        flag = core_sorted[pidx] & inb
        tgt = torch.cumsum(flag.to(torch.int64), dim=1) - 1
        out = torch.zeros_like(pidx)
        out.scatter_reduce_(
            1, torch.where(flag, tgt, torch.full_like(tgt, width - 1)),
            torch.where(flag, pidx, torch.zeros_like(pidx)), "amax",
            include_self=True)
        setv = slot < flag.sum(dim=1)[:, None]
        return torch.where(setv, out, torch.zeros_like(out)), setv

    # width tiers: a pair's point sets are padded to the power of two
    # at or above the larger occupancy of its two grids (at most m_cap),
    # not to m_cap.  A grid's core set lies within its occupancy, and
    # FastMerging's decision and rounds do not depend on the padding
    # past the valid slots, so every pair decides as at m_cap.
    widths = sorted({min(caps.m_cap, 1 << k) for k in
                     range(3, max(caps.m_cap - 1, 1).bit_length() + 1)}
                    | {caps.m_cap})
    occ_pair = torch.maximum(counts[pg], counts[ph])
    tier = torch.clamp_max(torch.searchsorted(
        torch.tensor(widths, device=dev), occ_pair), len(widths) - 1)
    by_tier = torch.argsort(tier, stable=True)
    pair_cuts = host_read(torch.cumsum(
        torch.bincount(tier, minlength=len(widths)), 0))
    merged = torch.zeros((flat.numel(),), dtype=torch.bool, device=dev)
    for lo, hi, width in zip([0] + pair_cuts[:-1], pair_cuts, widths):
        step = max(1, MERGE_ELEMS // (width * d))
        for s in range(lo, hi, step):
            sel = by_tier[s:min(s + step, hi)]
            ai, av = core_set(pg[sel], width)
            bi, bv = core_set(ph[sel], width)
            yes, _ = fast_merging_batch(spts[ai], av, spts[bi], bv, eps,
                                        max_iters=caps.merge_iters)
            merged[sel] = yes
    stage_mark("merge", dev)

    edges = torch.stack([pg, ph], dim=1)
    grid_label = label_propagation(G, edges, merged, core_grid).to(torch.int64)
    # representative grid index per cluster; sentinel G for non-core grids
    num_clusters = ((grid_label == grid_rows) & core_grid).sum().to(torch.int32)
    stage_mark("components", dev)

    # ---- step 4: border / noise ----------------------------------------
    def border_rows(gsel, width):
        cand_idx, cand_grid, cand_valid, _ = _candidates_for_grids(
            dg, nbr, gsel, width)
        cand_valid = cand_valid & core_sorted[cand_idx]
        own_idx, own_valid = own_rows(gsel)
        noncore = own_valid & ~core_sorted[own_idx]
        a = spts[own_idx]
        b = spts[cand_idx]
        if caps.use_kernels:
            anchor = grid_anchor(gsel)
            dbest, jbest = kernel_ops.row_min_batch(a - anchor, b - anchor,
                                                    valid_b=cand_valid)
            # jbest == -1: no core candidate at all (row_min contract);
            # dbest is inf there, so the eps2 test already rejects it --
            # the clamp only keeps the gather in range
            jbest = torch.clamp_min(jbest.to(torch.int64), 0)
        else:
            d2 = torch.where(cand_valid[:, None, :],
                             kernel_ops.sq_dists_direct(a, b), torch.inf)
            jbest = torch.argmin(d2, dim=2)
            dbest = torch.gather(d2, 2, jbest[..., None])[..., 0]
        gbest = torch.gather(cand_grid, 1, jbest)
        lab = torch.where((dbest <= eps2) & noncore, grid_label[gbest],
                          torch.full_like(gbest, G))
        return own_idx, lab

    border_plan = sweeps
    if caps.packed:
        # a grid whose points are all core assigns no border label: each
        # tier's grids that hold a non-core point go first (stable), and
        # the border sweep visits only those (one host read)
        noncore = torch.zeros((G,), dtype=torch.int64, device=dev)
        noncore.index_add_(0, point_grid,
                           (sorted_valid & ~core_sorted).to(torch.int64))
        need = noncore[pperm] > 0
        tier_of = torch.searchsorted(
            torch.tensor(cuts, device=dev), grid_rows, right=True)
        bperm = pperm[torch.argsort(tier_of * 2 + (~need).to(torch.int64),
                                    stable=True)]
        kept = host_read(torch.bincount(
            torch.where(need, tier_of, len(cuts)),
            minlength=len(cuts) + 1)[:len(cuts)])
        border_plan = [(bperm, lo, lo + k, w)
                       for (_, lo, _, w), k in zip(sweeps, kept)]
    border_sorted = sweep(
        border_rows, torch.full((n,), G, dtype=torch.int64, device=dev),
        "amin", border_plan)
    stage_mark("border", dev)

    lab_sorted = torch.where(core_sorted, grid_label[point_grid],
                             border_sorted)
    lab_sorted = torch.where(lab_sorted >= G,
                             torch.full_like(lab_sorted, -1), lab_sorted)
    lab_sorted = torch.where(sorted_valid, lab_sorted,
                             torch.full_like(lab_sorted, -1))

    labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    labels[order] = lab_sorted.to(torch.int32)
    core = torch.zeros((n,), dtype=torch.bool, device=dev)
    core[order] = core_sorted
    point_grid_orig = torch.zeros((n,), dtype=torch.int32, device=dev)
    point_grid_orig[order] = dg.point_grid
    report = OverflowReport(
        grid=dg.overflow, frontier=ovf_frontier, neighbors=ovf_k,
        candidates=ovf_candidates, core_set=ovf_core_set, pairs=ovf_pairs,
        halo=torch.zeros((), dtype=torch.bool, device=dev))
    stage_mark("labels", dev)
    return DeviceDBSCANResult(labels=labels, core=core,
                              point_grid=point_grid_orig,
                              num_clusters=num_clusters,
                              overflow=report.any(), report=report,
                              dispatch_tiers=dispatch_tiers,
                              tier_counts=tier_counts)
