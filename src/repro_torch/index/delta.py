"""Unified mutation plane for a fitted :class:`GritIndex`: one *delta
engine* behind both :meth:`insert` and :meth:`delete`.

Both mutation directions perturb a fitted state the same way -- through
the offset-stencil of the grids they touch -- so both run the same
direction-parameterized stages:

1. **touched -> stencil closure**: the grids holding mutated rows, plus
   their grid-tree neighborhood ``Nei(touched)`` (any point within eps
   of a mutated point lives there -- the paper's stencil bound).
2. **core recompute** over the closure, from scratch against full
   own+stencil candidate sets, filtered to live rows.  Direction prunes
   the candidates: insertion is monotone up (only non-core rows can
   gain), deletion monotone down (only core rows can lose); a grid with
   ``live_count >= MinPts`` short-circuits either way (its diagonal is
   eps, so every live member is core from the own count alone).
3. **merge re-decision** at *changed-core-set* grids, maintaining the
   persistent core-grid **merge graph** (``GritIndex.merge_edges``): a
   MinDist decision depends on nothing but the two core sets and is
   monotone in them, so under insertion existing edges stay valid and
   only missing candidate pairs are decided, while under deletion no
   new edge can appear and only the *present* edges incident to a
   changed grid are re-decided.
4. **label reconciliation** by connected components over the merge
   graph (grid-level, hence cheap: min-label propagation over G nodes).
   Every core takes its component's label; components keep the smallest
   previous label they contain, splits keep it on the smallest-root
   side and mint fresh ids for the rest, brand-new components mint
   fresh ids -- so unaffected clusters keep their ids bit-stably.
5. **border pass**: the nearest-live-core test for exactly the rows a
   mutation can flip -- new non-core rows and noise in the changed
   stencil under insertion; labeled non-core rows in the changed
   stencil plus any row whose previous cluster id split or vanished
   under deletion.

Exactness under deletion (DESIGN.md §7).  DBSCAN is **not** monotone
under deletion -- removing one bridge point can split a cluster in two
-- but the perturbation is still local at the *grid* level: counts
shrink only in touched grids, so cores demote only in
``touched ∪ Nei(touched)``; a MinDist decision changes only where a
core *set* changed, so merge edges vanish only at changed grids; and
because the merge graph is persistent and complete (every true edge is
stored, not just a spanning subset), recomputing connected components
over it after the local edge repair is *globally* exhaustive -- a split
anywhere manifests as the component falling apart, even when the two
halves are far from the deleted rows.  Borders are exhaustive by the
same stencil argument: a border's witness core lies in its own stencil,
so a border outside ``Nei(changed)`` whose cluster id survived intact
needs no distance work at all (its witness provably survived), and
every other candidate is re-tested.  Deleted rows tombstone first
(``alive=False``; physical rows keep the CSR layout intact) and a
threshold-triggered :func:`compact` re-packs the flat arrays -- an
order-preserving mask compress, cheaper than insert's re-sort.

Everything runs in float64 with the brute oracle's distance expression,
so either mutation followed by a read-out is label-conformant with a
from-scratch ``cluster()`` on the surviving set.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..core.grids import group_rows
from ..core.merging import fast_merging

__all__ = ["MutationLog", "build_merge_graph", "grid_components",
           "insert_batch", "delete_ids", "compact",
           "relabel_local_components"]


# --------------------------------------------------------------------------
# mutation log (replica replay)
# --------------------------------------------------------------------------

class MutationLog:
    """Ordered record of an index's *top-level* mutation batches.

    The delta engine is deterministic: applying the same ``(insert,
    delete)`` batches in the same order to the same starting state
    reproduces the fitted state bit for bit.  That makes the mutation
    *arguments* a sufficient replication log -- no per-row state diffs
    on the wire -- and the engine itself the replay operator: a
    read-only replica clones the primary's snapshot and then replays
    ``since(cursor)``.

    Records are ``(op, payload)`` with ``op`` in ``{"insert",
    "delete", "split", "merge"}`` and ``payload`` the verbatim batch
    (``[m, d]`` float64 coordinates / raw requested arrival ids --
    rejected ids replay to the same rejections, so they stay in the
    record / the ``[1]`` shard index of a sharded topology op, which
    must replay too: in the localized regime a topology op re-mints
    label ids, and a replica that skipped it would drift in the id
    space even though the partition agrees).  ``base`` is the
    op sequence number of the first retained record: :meth:`truncate`
    drops a replayed prefix without renumbering, so replica cursors
    stay valid as long as they are >= ``base``.
    """

    def __init__(self, base: int = 0):
        self.base = int(base)
        self.records: List[Tuple[str, np.ndarray]] = []

    @property
    def end(self) -> int:
        """Sequence number one past the last recorded op."""
        return self.base + len(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def append(self, op: str, payload: np.ndarray) -> None:
        if op not in ("insert", "delete", "split", "merge"):
            raise ValueError(f"unknown mutation-log op {op!r}")
        self.records.append((op, np.asarray(payload).copy()))

    def since(self, cursor: int) -> List[Tuple[str, np.ndarray]]:
        """The records a replica at ``cursor`` still has to replay.

        Raises ``ValueError`` when the prefix up to ``cursor`` was
        already truncated away -- the replica is too stale to catch up
        and must re-clone from a fresh snapshot.
        """
        if cursor < self.base:
            raise ValueError(
                f"mutation-log cursor {cursor} predates the log base "
                f"{self.base}: the prefix was truncated; re-clone the "
                f"replica from a fresh snapshot")
        return self.records[cursor - self.base:]

    def truncate(self, keep_from: int) -> int:
        """Drop records before op ``keep_from`` (bounded retention);
        returns how many were dropped.  Sequence numbers are stable:
        ``base`` advances instead of renumbering."""
        drop = min(max(keep_from - self.base, 0), len(self.records))
        if drop:
            del self.records[:drop]
            self.base += drop
        return drop


# --------------------------------------------------------------------------
# persistent merge graph
# --------------------------------------------------------------------------

def _core_count_per_grid(index) -> np.ndarray:
    """Live core points per grid (from the core CSR cache)."""
    _, _, ccounts = index._core_ranges()
    return ccounts


_PROD_CAP = 4096       # |S_a|*|S_b| beyond which FastMerging wins
_FLAT_CHUNK = 2 ** 21  # flat distance evals per vectorized chunk


def _bbox_survivors(index, pairs: np.ndarray) -> np.ndarray:
    """Tier-1 axis-aligned core-bbox gap reject, shared by the host and
    device edge deciders: per-grid core sets are eps-diameter-bounded,
    so the bound is tight and kills most far-offset stencil pairs
    without any distance work.  The reject threshold carries a 1+1e-12
    guard so a knife-edge pair can never be lost to the sum's rounding;
    survivors must be decided by the exact expression.  Returns the
    indices into ``pairs`` that survive.
    """
    core_rows, cstarts, ccounts = index._core_ranges()
    pts, eps = index.points, index.eps
    cpts = pts[core_rows]
    # per-grid core bboxes: reduceat over the core-bearing grids only
    # -- their cstarts are exactly the segment starts of the core CSR,
    # so the last segment runs to len(core_rows) (clamping zero-core
    # grids' starts instead would shear the final grid's segment and
    # shrink its bbox, falsely rejecting true edges)
    cg = np.flatnonzero(ccounts > 0)
    if len(cg) == 0:
        return np.empty(0, np.int64)
    lo = np.empty((len(ccounts), pts.shape[1]))
    hi = np.empty_like(lo)
    lo[cg] = np.minimum.reduceat(cpts, cstarts[cg], axis=0)
    hi[cg] = np.maximum.reduceat(cpts, cstarts[cg], axis=0)
    a, b = pairs[:, 0], pairs[:, 1]
    gap = np.maximum(0.0, np.maximum(lo[a] - hi[b], lo[b] - hi[a]))
    return np.flatnonzero(
        (gap * gap).sum(1) <= eps * eps * (1 + 1e-12))


def _decide_edges_batch(index, pairs: np.ndarray,
                        ctr: Dict[str, int]) -> np.ndarray:
    """Exact MinDist(S_a, S_b) <= eps for many grid pairs at once.

    Three tiers, cheapest first, all on the oracle's float64 d2
    expression: (1) the vectorized core-bbox gap reject
    (:func:`_bbox_survivors`); (2) one flat broadcast over every
    surviving pair with a small core-set product (the common case --
    one numpy call per ~2M evals instead of one Python call per pair);
    (3) FastMerging (Algorithm 5) for the rare huge products, where
    its pruning wins.  Returns a bool hit mask aligned with ``pairs``.
    """
    if len(pairs) == 0:
        return np.zeros(0, bool)
    core_rows, cstarts, ccounts = index._core_ranges()
    pts, eps = index.points, index.eps
    eps2 = eps * eps
    a, b = pairs[:, 0], pairs[:, 1]
    hit = np.zeros(len(pairs), bool)
    rem = _bbox_survivors(index, pairs)
    if len(rem) == 0:
        return hit
    # fixed-shape sample accept: ANY pair of cores within eps proves
    # the edge, so an 8x8 probe (clamped repeats for smaller sets)
    # confirms most true edges in one vectorized shot
    sa = core_rows[cstarts[a[rem]][:, None]
                   + np.minimum(np.arange(8)[None, :],
                                ccounts[a[rem]][:, None] - 1)]
    sb = core_rows[cstarts[b[rem]][:, None]
                   + np.minimum(np.arange(8)[None, :],
                                ccounts[b[rem]][:, None] - 1)]
    d2s = ((pts[sa][:, :, None, :] - pts[sb][:, None, :, :]) ** 2
           ).sum(-1)
    ctr["dist_evals"] += d2s.size
    confirmed = d2s.reshape(len(rem), -1).min(1) <= eps2
    hit[rem[confirmed]] = True
    rem = rem[~confirmed]
    if len(rem) == 0:
        return hit
    prod = ccounts[a[rem]] * ccounts[b[rem]]
    big = prod > _PROD_CAP
    for i in rem[big]:
        hit[i] = fast_merging(pts[index.grid_core_rows(pairs[i, 0])],
                              pts[index.grid_core_rows(pairs[i, 1])],
                              eps)
    sm = rem[~big]
    prod = prod[~big]
    bounds = np.searchsorted(np.cumsum(prod), np.arange(
        _FLAT_CHUNK, int(prod.sum()) + _FLAT_CHUNK, _FLAT_CHUNK))
    for s, e in zip(np.concatenate([[0], bounds[:-1]]), bounds):
        if s == e:
            continue
        p = sm[s:e]
        na, nb_ = ccounts[a[p]], ccounts[b[p]]
        pp = na * nb_
        off = np.cumsum(pp) - pp
        total = int(pp.sum())
        pair_of = np.repeat(np.arange(len(p)), pp)
        within = np.arange(total) - off[pair_of]
        ai = within // nb_[pair_of]
        bi = within - ai * nb_[pair_of]
        A = core_rows[cstarts[a[p]][pair_of] + ai]
        B = core_rows[cstarts[b[p]][pair_of] + bi]
        d2 = ((pts[A] - pts[B]) ** 2).sum(1)
        ctr["dist_evals"] += d2.size
        hit[p] = np.minimum.reduceat(d2, off) <= eps2
    return hit


def _decide_edges(index, pairs: np.ndarray,
                  ctr: Dict[str, int]) -> np.ndarray:
    """Route MinDist decisions to the device plane when the index holds
    a resident :class:`~repro_torch.index.device_state.DeviceState`
    (pair minima of float32 distances under the guard band, host float64 for the uncertain
    pairs -- decision-identical by construction)."""
    ds = getattr(index, "device_state", None)
    if ds is None:
        return _decide_edges_batch(index, pairs, ctr)
    from . import device_state
    return device_state.decide_edges_device(index, ds, pairs, ctr)


def build_merge_graph(index) -> np.ndarray:
    """Decide the full core-grid merge graph of the current state.

    One MinDist decision per unordered neighbor pair of core grids --
    the cost shape of a fit's merging phase.  Run once (lazily) per
    index lifetime; mutations maintain the result incrementally.
    """
    ccnt = _core_count_per_grid(index)
    cg = np.flatnonzero(ccnt > 0)
    if len(cg) == 0:
        return np.zeros((0, 2), np.int64)
    G = index.num_grids
    ip, nb, _ = index.tree.query(index.ids[cg], include_self=False)
    src = np.repeat(cg, np.diff(ip))
    ok = (ccnt[nb] > 0) & (src < nb)       # each unordered pair once
    key = np.unique(src[ok] * G + nb[ok])
    pairs = np.stack([key // G, key % G], 1)
    if len(pairs) == 0:
        return np.zeros((0, 2), np.int64)
    ctr: Dict[str, int] = {"dist_evals": 0}
    return pairs[_decide_edges(index, pairs, ctr)]


def grid_components(num_grids: int,
                    edges: Optional[np.ndarray]) -> np.ndarray:
    """Connected components over the grid merge graph.

    Vectorized min-label propagation with pointer jumping (the host
    twin of ``repro_torch.core.labels.label_propagation``): O(E) work per
    round, O(log G) rounds.  Returns [G] component representative =
    smallest grid index in the component (isolated grids map to self).
    """
    lab = np.arange(num_grids, dtype=np.int64)
    if edges is None or len(edges) == 0:
        return lab
    a, b = edges[:, 0], edges[:, 1]
    while True:
        m = np.minimum(lab[a], lab[b])
        new = lab.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = new[new]
        new = new[new]                     # pointer jumping
        if np.array_equal(new, lab):
            return lab
        lab = new


# --------------------------------------------------------------------------
# shared stages (direction: +1 insert, -1 delete)
# --------------------------------------------------------------------------

def _recompute_cores(index, affected, direction: int,
                     ctr: Dict[str, int]) -> np.ndarray:
    """Stage 2 dispatcher: device twin when a resident state is
    attached (flip-set-identical -- see ``recompute_cores_device``),
    host float64 loop otherwise."""
    ds = getattr(index, "device_state", None)
    if ds is None:
        return _recompute_cores_host(index, affected, direction, ctr)
    from . import device_state
    return device_state.recompute_cores_device(
        index, ds, affected, direction, ctr)


def _recompute_cores_host(index, affected, direction: int,
                          ctr: Dict[str, int]) -> np.ndarray:
    """Stage 2: re-derive core status inside the stencil closure.

    Returns the sorted-order rows whose flag flipped (promotions under
    +1, demotions under -1); flips are applied to ``index.core`` in
    place.  Counts run against *live* rows only, neighbor grids in
    offset-ascending order with the MinPts early exit.  Monotonicity
    prunes the closure up front: under insertion only grids holding a
    live non-core row can change, under deletion only grids below the
    all-core bar (``live_count < MinPts``) that still hold a core.
    """
    pts, core, alive = index.points, index.core, index.alive
    starts, counts = index.starts, index.counts
    live_counts, min_pts = index.live_counts, index.min_pts
    eps2 = index.eps * index.eps
    ccnt = _core_count_per_grid(index)
    if direction > 0:
        need = affected[live_counts[affected] > ccnt[affected]]
    else:
        need = affected[(live_counts[affected] < min_pts)
                        & (ccnt[affected] > 0)]
    if len(need) == 0:
        return np.empty(0, np.int64)
    ip, nb, _ = index.tree.query(index.ids[need], include_self=False)
    flips = []
    for k, g in enumerate(need):
        own = np.arange(starts[g], starts[g] + counts[g])
        own = own[alive[own]]
        if direction > 0:
            cand = own[~core[own]]
            if live_counts[g] >= min_pts:      # all-live-core shortcut
                if len(cand):
                    core[cand] = True
                    flips.append(cand)
                continue
        else:
            cand = own[core[own]]
        if len(cand) == 0:
            continue
        p = pts[cand]
        cnt = np.full(len(cand), live_counts[g], np.int64)
        undecided = cnt < min_pts
        for ng in nb[ip[k]:ip[k + 1]]:         # offset-ascending
            if not undecided.any():
                break
            crows = np.arange(starts[ng], starts[ng] + counts[ng])
            crows = crows[alive[crows]]
            if len(crows) == 0:
                continue
            d2 = ((p[undecided][:, None, :]
                   - pts[crows][None, :, :]) ** 2).sum(-1)
            ctr["dist_evals"] += d2.size
            cnt[undecided] += (d2 <= eps2).sum(1)
            undecided = cnt < min_pts
        flip = cand[cnt >= min_pts] if direction > 0 \
            else cand[cnt < min_pts]
        if len(flip):
            core[flip] = not (direction < 0)
            flips.append(flip)
    return (np.concatenate(flips) if flips
            else np.empty(0, np.int64))


def _update_merge_edges(index, changed: np.ndarray, direction: int,
                        ctr: Dict[str, int]) -> None:
    """Stage 3: repair the persistent merge graph at changed grids.

    Both directions exploit monotonicity of MinDist over the core
    sets.  Insert: cores were only added, so every stored edge stays
    valid and only *missing* candidate pairs (changed grid x core
    neighbor, from the tree) are decided.  Delete: cores were only
    removed, so no new edge can appear and only the *present* edges
    incident to a changed grid are re-decided -- no stencil sweep at
    all.
    """
    G = index.num_grids
    edges = index.merge_edges
    ccnt = _core_count_per_grid(index)
    in_changed = np.zeros(G, bool)
    in_changed[changed] = True
    if direction < 0:
        if not len(edges):
            return
        inc = in_changed[edges[:, 0]] | in_changed[edges[:, 1]]
        keep, pairs = edges[~inc], edges[inc]
        # an endpoint with no surviving cores loses its edges outright
        pairs = pairs[(ccnt[pairs[:, 0]] > 0) & (ccnt[pairs[:, 1]] > 0)]
    else:
        keep = edges
        ch = changed[ccnt[changed] > 0]
        pairs = np.zeros((0, 2), np.int64)
        if len(ch):
            ip, nb, _ = index.tree.query(index.ids[ch],
                                         include_self=False)
            src = np.repeat(ch, np.diff(ip))
            ok = (ccnt[nb] > 0) & (src != nb)
            a = np.minimum(src[ok], nb[ok])
            b = np.maximum(src[ok], nb[ok])
            if len(a):
                key = np.unique(a * G + b)
                pairs = np.stack([key // G, key % G], 1)
        if len(keep) and len(pairs):
            known = np.isin(pairs[:, 0] * G + pairs[:, 1],
                            keep[:, 0] * G + keep[:, 1])
            pairs = pairs[~known]
    ctr["merge_checks"] += len(pairs)
    new = pairs[_decide_edges(index, pairs, ctr)]
    merged = np.concatenate([keep, new])
    if len(merged):
        # keep ∪ new is duplicate-free by construction (insert decides
        # only missing pairs; delete's re-decided pairs are disjoint
        # from keep) -- a key argsort restores canonical order without
        # the structured-unique sort
        merged = merged[np.argsort(merged[:, 0] * G + merged[:, 1],
                                   kind="stable")]
    index.merge_edges = merged


def _relabel_components(index, grid_of: np.ndarray,
                        ctr: Dict[str, int]) -> np.ndarray:
    """Stage 4: core labels from connected components over the graph.

    Returns ``remap`` ([old_next_label] int64): for every previous
    cluster id, its new id, ``-1`` if the cluster vanished, or ``-2``
    if it split across components (borders carrying such an id must be
    re-tested -- direct remapping would glue them to one half blindly).
    """
    G = index.num_grids
    lab = index.labels
    core_rows = np.flatnonzero(index.core)
    comp = grid_components(G, index.merge_edges)
    old_next = index.next_label
    remap = np.full(old_next, -1, np.int64)
    final = np.full(G, -1, np.int64)
    roots = np.unique(comp[grid_of[core_rows]]) if len(core_rows) \
        else np.empty(0, np.int64)
    lc = core_rows[lab[core_rows] >= 0]
    if len(lc):
        # dedupe (root, label) pairs through one flat int64 key: a
        # single 1-D sort, much cheaper than a structured axis-unique
        key = np.unique(comp[grid_of[lc]] * np.int64(old_next)
                        + lab[lc])
        pairs = np.stack([key // old_next, key % old_next], 1)
    else:
        pairs = np.zeros((0, 2), np.int64)
    if len(pairs):
        # keeper(L) = smallest component root containing old label L
        o = np.lexsort((pairs[:, 0], pairs[:, 1]))
        pl = pairs[o]
        first = np.ones(len(pl), bool)
        first[1:] = pl[1:, 1] != pl[:-1, 1]
        keeper = np.full(old_next, -1, np.int64)
        keeper[pl[first, 1]] = pl[first, 0]
        n_roots = np.zeros(old_next, np.int64)
        np.add.at(n_roots, pairs[:, 1], 1)
        # a root's final label: the smallest old label it keeps
        kept = pairs[keeper[pairs[:, 1]] == pairs[:, 0]]
        sent = np.iinfo(np.int64).max
        best = np.full(G, sent, np.int64)
        np.minimum.at(best, kept[:, 0], kept[:, 1])
        final[best < sent] = best[best < sent]
        labs = np.unique(pairs[:, 1])
        remap[labs] = np.where(n_roots[labs] == 1,
                               final[keeper[labs]], -2)
    fresh = roots[final[roots] < 0]
    final[fresh] = old_next + np.arange(len(fresh))
    index.next_label = old_next + len(fresh)
    if len(core_rows):
        old = lab[core_rows]
        lab[core_rows] = final[comp[grid_of[core_rows]]]
        ctr["relabeled"] += int((old != lab[core_rows]).sum())
    return remap


def _reconcile_noncore(index, grid_of: np.ndarray, changed: np.ndarray,
                       remap: np.ndarray, direction: int,
                       new_rows: Optional[np.ndarray],
                       ctr: Dict[str, int]) -> None:
    """Stage 4b/5: remap surviving border labels, re-test the rest.

    Splits the live non-core rows into direct remaps (their previous
    cluster id survived intact AND their stencil holds no changed grid,
    so their witness core provably survived) and suspects that take the
    nearest-live-core test from scratch.
    """
    G = index.num_grids
    lab, core, alive = index.labels, index.core, index.alive
    in_stencil = np.zeros(G, bool)
    if len(changed):
        in_stencil[changed] = True
        ip, nb, _ = index.tree.query(index.ids[changed],
                                     include_self=False)
        in_stencil[nb] = True
    nc = np.flatnonzero(alive & ~core & (lab >= 0))
    suspects = []
    if len(nc):
        mapped = remap[lab[nc]]
        if direction > 0:
            # insertion never splits or vanishes a cluster within one
            # fit lineage, so labeled borders remap directly -- EXCEPT
            # in a shard freshly built by a topology op (split/merge
            # pools a slab-local view), where one pooled cluster id can
            # span several *local* components: those borders arrive
            # here with a negative remap and must take the
            # from-scratch nearest-core test instead of inheriting the
            # sentinel verbatim
            risky = mapped < 0
            ctr["relabeled"] += int((mapped[~risky]
                                     != lab[nc[~risky]]).sum())
            lab[nc[~risky]] = mapped[~risky]
            if risky.any():
                suspects.append(nc[risky])
        else:
            risky = (mapped < 0) | in_stencil[grid_of[nc]]
            ctr["relabeled"] += int((mapped[~risky]
                                     != lab[nc[~risky]]).sum())
            lab[nc[~risky]] = mapped[~risky]
            suspects.append(nc[risky])
    if direction > 0:
        noise = np.flatnonzero(alive & ~core & (lab < 0)
                               & in_stencil[grid_of])
        suspects.append(noise)
        if new_rows is not None:
            suspects.append(new_rows[~core[new_rows]])
    rows = (np.unique(np.concatenate(suspects)) if suspects
            else np.empty(0, np.int64))
    _border_pass(index, rows, grid_of, ctr)


def _border_pass(index, rows: np.ndarray, grid_of: np.ndarray,
                 ctr: Dict[str, int]) -> None:
    """Stage 5 dispatcher: device twin when a resident state is
    attached (label-identical -- see ``border_pass_device``), host
    float64 loop otherwise."""
    ds = getattr(index, "device_state", None)
    if ds is None:
        return _border_pass_host(index, rows, grid_of, ctr)
    from . import device_state
    return device_state.border_pass_device(index, ds, rows, grid_of, ctr)


def _border_pass_host(index, rows: np.ndarray, grid_of: np.ndarray,
                      ctr: Dict[str, int]) -> None:
    """Nearest-live-core test for ``rows`` (sorted, non-core, live):
    within eps of a core -> that core's (already final) label, else
    noise.  Candidates from the own+stencil core CSR -- complete by
    the stencil bound."""
    if len(rows) == 0:
        return
    pts, lab = index.points, index.labels
    starts, counts = index.starts, index.counts
    eps2 = index.eps * index.eps
    lab[rows] = -1
    cgrids = np.unique(grid_of[rows])
    ip, nb, _ = index.tree.query(index.ids[cgrids], include_self=False)
    for k, g in enumerate(cgrids):
        rr = rows[(rows >= starts[g]) & (rows < starts[g] + counts[g])]
        crows = np.concatenate(
            [index.grid_core_rows(g)]
            + [index.grid_core_rows(g2) for g2 in nb[ip[k]:ip[k + 1]]])
        if len(crows) == 0:
            continue
        d2 = ((pts[rr][:, None, :] - pts[crows][None, :, :]) ** 2).sum(-1)
        ctr["dist_evals"] += d2.size
        j = d2.argmin(axis=1)
        hit = d2[np.arange(len(rr)), j] <= eps2
        lab[rr[hit]] = lab[crows[j[hit]]]


def _grid_of_rows(index) -> np.ndarray:
    return np.repeat(np.arange(index.num_grids, dtype=np.int64),
                     index.counts)


def _ensure_graph(index, ctr: Dict[str, Any]) -> None:
    """Lazy-build the merge graph when a mutation first needs it.

    Called *after* the core flags are current, so the from-scratch
    build IS the repaired graph and stage 3 can be skipped for this
    mutation (``merge_graph_built`` marks the one-time cost)."""
    index.merge_edges = build_merge_graph(index)
    ctr["merge_graph_built"] = True


# --------------------------------------------------------------------------
# insert
# --------------------------------------------------------------------------

def insert_batch(index, batch) -> Dict[str, Any]:
    """Splice ``batch`` ([m, d]) into ``index`` in place.

    Returns the **unified mutation stats schema** (shared key-for-key
    with ``ShardedGritIndex.insert``, which shard-sums the counters):

    * ``op``: ``"insert"``.
    * ``inserted``: points spliced in (== len(batch)).
    * ``n`` / ``n_live``: physical rows / live points after the splice.
    * ``touched_grids`` / ``affected_grids`` / ``changed_grids``: grids
      holding new rows / their stencil closure / grids whose core set
      changed.
    * ``newly_core``: points promoted to core.
    * ``merge_checks`` / ``dist_evals``: FastMerging decisions and
      float64 distance evaluations spent.
    * ``relabeled``: rows whose cluster id changed (splices/merges).
    * ``t_total``: wall seconds.

    Single-index extras (not part of the shared schema):
    ``newly_core_arrival`` (arrival ids of the promotions -- what a
    multi-shard caller dedupes ghost copies with), ``id_shifted``
    (lattice translation happened), ``merge_graph_built`` (this call
    paid the one-time lazy graph build).

    Raises ``ValueError`` on shape/NaN problems, mirroring
    ``cluster()``'s input validation.
    """
    t0 = time.perf_counter()
    B = np.asarray(batch, np.float64)
    if B.ndim != 2 or B.shape[1] != index.d:
        raise ValueError(f"insert batch must be [m, {index.d}], "
                         f"got {B.shape}")
    m = B.shape[0]
    ctr: Dict[str, Any] = dict(merge_checks=0, dist_evals=0, relabeled=0,
                               merge_graph_built=False)
    if m == 0:
        return _insert_stats(index, t0, ctr, inserted=0, touched=0,
                             affected=0, changed=0,
                             newly_core=np.empty(0, np.int64),
                             shifted=False)
    if not np.isfinite(B).all():
        raise ValueError("insert batch contains non-finite coordinates")

    # ---- 1. identifiers (fit-time formula) + origin shift ---------------
    with obs.span("delta.insert.identifiers"):
        new_ids = index.query_ids(B)
        neg = np.minimum(new_ids.min(axis=0), 0)
        shifted = bool((neg < 0).any())
        if shifted:
            # keep the stored-ids >= 0 invariant by translating the
            # integer lattice -- never by moving the float origin, which
            # could re-cell existing points through rounding.  A uniform
            # shift preserves lex order, so grid numbering (and the merge
            # graph's endpoints) are untouched.
            shift = (-neg).astype(np.int64)
            index.ids = index.ids + shift[None, :]
            new_ids = new_ids + shift[None, :]
            index.id_shift = index.id_shift + shift

    # ---- 2. merge into the sorted structure -----------------------------
    with obs.span("delta.insert.splice") as sp:
        n_old, G_old = index.n, index.num_grids
        old_grid_of = _grid_of_rows(index)
        old_pt_ids = np.repeat(index.ids, index.counts, axis=0)   # [n, d]
        all_ids = np.concatenate([old_pt_ids, new_ids])
        order, sids, starts, counts, grid_of = group_rows(all_ids)
        index.points = np.concatenate([index.points, B])[order]
        index.arrival = np.concatenate(
            [index.arrival,
             index.next_arrival + np.arange(m, dtype=np.int64)])[order]
        index.next_arrival += m
        index.core = np.concatenate([index.core, np.zeros(m, bool)])[order]
        index.alive = np.concatenate([index.alive, np.ones(m, bool)])[order]
        index.labels = np.concatenate(
            [index.labels, np.full(m, -1, np.int64)])[order]
        index.ids = sids[starts]
        index.starts, index.counts = starts, counts
        index.live_counts = np.bincount(
            grid_of, weights=index.alive, minlength=len(starts)
            ).astype(np.int64)
        if index.merge_edges is not None and G_old:
            # re-sorting renumbers grids; old grids survive (their rows
            # do), so map each old index to its new one through any of
            # its rows and carry the edge list over
            old_rows = order < n_old
            old_to_new = np.empty(G_old, np.int64)
            old_to_new[old_grid_of[order[old_rows]]] = grid_of[old_rows]
            if len(index.merge_edges):
                index.merge_edges = old_to_new[index.merge_edges]
        index.invalidate()
        is_new = order >= n_old                                   # sorted
        ds = getattr(index, "device_state", None)
        if ds is not None:
            # splice rewrote the row layout: structural re-upload (also
            # folds the new coordinates into the error-band span)
            ds.refresh_rows(index)
            sp.sync(ds.points_res, ds.alive_res, ds.core_res)

    # ---- 3. core recompute over the touched stencil ---------------------
    with obs.span("delta.insert.cores") as sp:
        tree = index.tree
        touched = np.unique(grid_of[is_new])
        ip_t, nb_t, _ = tree.query(index.ids[touched], include_self=False)
        affected = np.unique(np.concatenate([touched, nb_t]))
        newly_core = _recompute_cores(index, affected, +1, ctr)
        index.invalidate(keep_tree=True)  # core CSR is stale now
        if ds is not None:
            sp.sync(ds.core_res)          # the in-place core flips

    # ---- 4. merge-graph repair at changed-core-set grids ----------------
    with obs.span("delta.insert.merge_repair"):
        changed = (np.unique(grid_of[newly_core]) if len(newly_core)
                   else np.empty(0, np.int64))
        if index.merge_edges is None:
            _ensure_graph(index, ctr)     # post-splice state == repaired
        elif len(changed):
            _update_merge_edges(index, changed, +1, ctr)

    # ---- 5. label reconciliation + border pass --------------------------
    with obs.span("delta.insert.reconcile") as sp:
        remap = _relabel_components(index, grid_of, ctr)
        _reconcile_noncore(index, grid_of, changed, remap, +1,
                           np.flatnonzero(is_new), ctr)
        if ds is not None:
            ds.refresh_small(index)       # CSR + merge-edge mirrors
            sp.sync(ds.merge_edges_res)

    reg = obs.registry()
    reg.counter("delta.insert.count").inc()
    reg.counter("delta.insert.points").inc(m)
    reg.counter("delta.dist_evals").inc(int(ctr["dist_evals"]))
    reg.counter("delta.merge_checks").inc(int(ctr["merge_checks"]))
    return _insert_stats(index, t0, ctr, inserted=m,
                         touched=len(touched), affected=len(affected),
                         changed=len(changed), newly_core=newly_core,
                         shifted=shifted)


def _insert_stats(index, t0, ctr, *, inserted, touched, affected,
                  changed, newly_core, shifted) -> Dict[str, Any]:
    return {
        "op": "insert", "inserted": int(inserted),
        "n": index.n, "n_live": index.n_live,
        "touched_grids": int(touched), "affected_grids": int(affected),
        "changed_grids": int(changed),
        "newly_core": int(len(newly_core)),
        "newly_core_arrival": index.arrival[newly_core],
        "merge_checks": int(ctr["merge_checks"]),
        "dist_evals": int(ctr["dist_evals"]),
        "relabeled": int(ctr["relabeled"]),
        "id_shifted": bool(shifted),
        "merge_graph_built": bool(ctr["merge_graph_built"]),
        # device-path timing split (0.0 on the host path); excluded
        # from the differential stats comparison, like t_total
        "t_pack": float(ctr.get("t_pack", 0.0)),
        "t_kernel": float(ctr.get("t_kernel", 0.0)),
        "band_fallback": int(ctr.get("band_fallback", 0)),
        "t_total": time.perf_counter() - t0,
    }


# --------------------------------------------------------------------------
# delete
# --------------------------------------------------------------------------

def delete_ids(index, arrival_ids) -> Dict[str, Any]:
    """Exactly remove the points with the given arrival ids, in place.

    Ids that are unknown or already deleted are *rejected* (reported,
    not raised): deployed delete traffic -- TTL expiry racing explicit
    erasure, replayed requests -- carries them routinely.

    Returns the unified mutation stats schema (see
    :func:`insert_batch`) with ``op="delete"`` and the delete-specific
    keys: ``requested`` / ``deleted`` / ``rejected`` /
    ``rejected_ids``, ``demoted`` + ``demoted_arrival`` (cores that
    lost the MinPts bar; the direction twin of insert's
    ``newly_core``/``newly_core_arrival``), and ``compacted`` (this
    call crossed ``compact_threshold`` and re-packed).
    """
    t0 = time.perf_counter()
    ids = np.unique(np.asarray(arrival_ids, np.int64).ravel())
    ctr: Dict[str, Any] = dict(merge_checks=0, dist_evals=0, relabeled=0,
                               merge_graph_built=False)
    rows = index.rows_of_arrival(ids)
    ok = rows >= 0
    rejected = ids[~ok]
    rows = np.sort(rows[ok])
    if len(rows) == 0:
        return _delete_stats(index, t0, ctr, requested=len(ids),
                             deleted=0, rejected=rejected, touched=0,
                             affected=0, changed=0,
                             demoted=np.empty(0, np.int64),
                             compacted=False)

    # ---- 1. tombstone -----------------------------------------------------
    with obs.span("delta.delete.tombstone") as sp:
        grid_of = _grid_of_rows(index)
        was_core_grids = np.unique(grid_of[rows[index.core[rows]]])
        index.alive[rows] = False
        index.core[rows] = False
        index.labels[rows] = -1
        np.subtract.at(index.live_counts, grid_of[rows], 1)
        index.invalidate(keep_tree=True)  # ids untouched: tree survives
        ds = getattr(index, "device_state", None)
        if ds is not None:
            ds.mark_dead(rows)            # in-place tombstone of the mirror
            sp.sync(ds.alive_res, ds.core_res)

    # ---- 2. demotions over the touched stencil --------------------------
    with obs.span("delta.delete.demotions") as sp:
        tree = index.tree
        touched = np.unique(grid_of[rows])
        ip_t, nb_t, _ = tree.query(index.ids[touched], include_self=False)
        affected = np.unique(np.concatenate([touched, nb_t]))
        demoted = _recompute_cores(index, affected, -1, ctr)
        demoted_arrival = index.arrival[demoted]
        index.invalidate(keep_tree=True)
        if ds is not None:
            sp.sync(ds.core_res)          # the in-place core flips

    # ---- 3. merge-graph repair at changed-core-set grids ----------------
    # (a grid whose core was deleted outright changed too, even with no
    # demotion -- its surviving core set is smaller)
    with obs.span("delta.delete.merge_repair"):
        changed = np.unique(np.concatenate(
            [was_core_grids,
             grid_of[demoted] if len(demoted) else np.empty(0, np.int64)]))
        if index.merge_edges is None:
            _ensure_graph(index, ctr)
        elif len(changed):
            _update_merge_edges(index, changed, -1, ctr)

    # ---- 4. components + border reconciliation --------------------------
    with obs.span("delta.delete.components"):
        remap = _relabel_components(index, grid_of, ctr)
        _reconcile_noncore(index, grid_of, changed, remap, -1, None, ctr)

    # ---- 5. threshold-triggered compaction ------------------------------
    with obs.span("delta.delete.compaction") as sp:
        compacted = False
        if index.dead_fraction > index.compact_threshold:
            compact(index)                # refreshes the mirror itself
            compacted = True
        elif ds is not None:
            ds.refresh_small(index)
        if ds is not None:
            sp.sync(ds.points_res, ds.merge_edges_res)

    reg = obs.registry()
    reg.counter("delta.delete.count").inc()
    reg.counter("delta.delete.points").inc(len(rows))
    reg.counter("delta.dist_evals").inc(int(ctr["dist_evals"]))
    reg.counter("delta.merge_checks").inc(int(ctr["merge_checks"]))
    if compacted:
        reg.counter("delta.compactions").inc()
    return _delete_stats(index, t0, ctr, requested=len(ids),
                         deleted=len(rows), rejected=rejected,
                         touched=len(touched), affected=len(affected),
                         changed=len(changed), demoted=demoted_arrival,
                         compacted=compacted)


def _delete_stats(index, t0, ctr, *, requested, deleted, rejected,
                  touched, affected, changed, demoted,
                  compacted) -> Dict[str, Any]:
    return {
        "op": "delete", "requested": int(requested),
        "deleted": int(deleted), "rejected": int(len(rejected)),
        "rejected_ids": np.asarray(rejected, np.int64),
        "n": index.n, "n_live": index.n_live,
        "touched_grids": int(touched), "affected_grids": int(affected),
        "changed_grids": int(changed), "demoted": int(len(demoted)),
        # arrival ids of the demotions (direction twin of insert's
        # newly_core_arrival): lets a multi-shard caller attribute
        # demotions to owned vs ghost copies
        "demoted_arrival": np.asarray(demoted, np.int64),
        "merge_checks": int(ctr["merge_checks"]),
        "dist_evals": int(ctr["dist_evals"]),
        "relabeled": int(ctr["relabeled"]),
        "compacted": bool(compacted),
        "merge_graph_built": bool(ctr["merge_graph_built"]),
        "t_pack": float(ctr.get("t_pack", 0.0)),
        "t_kernel": float(ctr.get("t_kernel", 0.0)),
        "band_fallback": int(ctr.get("band_fallback", 0)),
        "t_total": time.perf_counter() - t0,
    }


# --------------------------------------------------------------------------
# label localization (multi-shard support)
# --------------------------------------------------------------------------

def relabel_local_components(index) -> Dict[str, Any]:
    """Re-mint every cluster id as a fresh per-*local*-component id.

    A sharded caller needs the invariant that one raw label means one
    connected component of *this* index's merge graph (and label
    arenas are disjoint across shards): a raw id shared by two shards
    -- or by two locally-disconnected pieces whose connection runs
    through another shard's coverage -- cannot be split by any global
    map once a deletion severs it.  This pass renames: each cored
    component takes a fresh id from ``next_label`` and every labeled
    non-core row re-takes the nearest-core test (its previous witness
    is still within eps, so it stays labeled -- by whichever local
    component that witness landed in).  Pure rename + witness-map
    rebuild on the caller's side: the read-out partition is unchanged.
    """
    t0 = time.perf_counter()
    ctr: Dict[str, Any] = dict(merge_checks=0, dist_evals=0, relabeled=0,
                               merge_graph_built=index.merge_edges is None)
    index.ensure_merge_graph()
    grid_of = _grid_of_rows(index)
    comp = grid_components(index.num_grids, index.merge_edges)
    core_rows = np.flatnonzero(index.core)
    roots = (np.unique(comp[grid_of[core_rows]]) if len(core_rows)
             else np.empty(0, np.int64))
    final = np.full(index.num_grids, -1, np.int64)
    final[roots] = index.next_label + np.arange(len(roots))
    index.next_label += len(roots)
    if len(core_rows):
        index.labels[core_rows] = final[comp[grid_of[core_rows]]]
    nc = np.flatnonzero(index.alive & ~index.core & (index.labels >= 0))
    _border_pass(index, nc, grid_of, ctr)
    return {"op": "localize", "components": int(len(roots)),
            "merge_graph_built": bool(ctr["merge_graph_built"]),
            "dist_evals": int(ctr["dist_evals"]),
            "t_total": time.perf_counter() - t0}


# --------------------------------------------------------------------------
# compaction
# --------------------------------------------------------------------------

def compact(index) -> Dict[str, Any]:
    """Re-pack the flat arrays, dropping tombstoned rows and empty grids.

    An order-preserving mask compress: rows stay lex-sorted, so no
    re-sort is needed; grid renumbering is a cumulative sum over the
    kept-grid mask and the merge graph's endpoints ride through it
    (an edge endpoint always holds live cores, so it is never
    dropped).  Arrival ids are preserved -- they are never reused, so
    ``delete`` and the sharded registries stay unambiguous across
    compactions.
    """
    t0 = time.perf_counter()
    removed = index.n - index.n_live
    if removed == 0:
        return {"op": "compact", "removed": 0, "grids_dropped": 0,
                "n": index.n, "t_total": time.perf_counter() - t0}
    keep = index.alive
    keep_grid = index.live_counts > 0
    new_of_old = np.cumsum(keep_grid) - 1
    if index.merge_edges is not None and len(index.merge_edges):
        index.merge_edges = new_of_old[index.merge_edges]
    grids_dropped = int((~keep_grid).sum())
    index.points = index.points[keep]
    index.arrival = index.arrival[keep]
    index.core = index.core[keep]
    index.labels = index.labels[keep]
    index.alive = np.ones(int(keep.sum()), bool)
    index.ids = index.ids[keep_grid]
    index.counts = index.live_counts[keep_grid].copy()
    index.live_counts = index.counts.copy()
    index.starts = np.cumsum(index.counts) - index.counts
    index.invalidate()
    ds = getattr(index, "device_state", None)
    if ds is not None:
        ds.refresh_rows(index)            # row layout rewritten
        ds.refresh_small(index)
    return {"op": "compact", "removed": int(removed),
            "grids_dropped": grids_dropped, "n": index.n,
            "t_total": time.perf_counter() - t0}
