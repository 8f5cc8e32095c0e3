"""Sharded fitted index: the serving artifact of a *distributed* fit.

One host's :class:`GritIndex` stops fitting exactly in the regime the
paper targets ("very large databases"), so the sharded index keeps the
fitted state *per slab*: one ``GritIndex`` per dim-0 slab (the same
slab partition the distributed fit used -- Wang/Gu/Shun's observation
that the fitted spatial structure is the artifact worth keeping across
machines), plus a global label map stitching the slabs' cluster ids
together.  de Berg et al.'s grid argument makes the routing cheap:
locating a query's owning slab is one binary search over the cut
coordinates.

**Ghost bands.**  Each shard stores its own slab's points *plus* ghost
copies of every foreign point within ``2 * eps`` of its slab range --
the same halo width as the distributed fit.  The width argument
(DESIGN.md §5) carries over verbatim: any point of slab k has its whole
eps-neighborhood inside [slab - eps, slab + eps) ⊂ shard k's coverage,
so every *own*-point decision (core status, merges, border assignment)
a shard makes is exact using only its local state -- at fit time and
under every later :meth:`insert`.

**Routing exactness** (predict).  A query owned by slab k can only have
core points within eps inside shard k's coverage, and every such core
carries an exact flag there (its neighborhood is complete in shard k),
so the owner's answer is already the brute-oracle assignment rule.
Queries within ``2 * eps`` of a cut additionally consult the adjacent
shard(s); answers combine by smallest squared distance with owner
priority on exact ties -- the neighbor can only confirm (its candidate
set is a subset of the true core set), so the combined answer stays
pinned bit-identical to the oracle rule (host mode: same float64
expression).

**Insert + re-reconciliation.**  A micro-batch is bucketed by owning
slab; each new point is spliced into its owner shard and, when it lies
in a neighbor's ghost band, into that neighbor too -- so every shard's
local state stays self-consistently exact (the fit-time invariant).
Label arenas never collide: each touched shard allocates fresh cluster
ids from the shared ``next_label`` sequence.  What *can* diverge is
cluster identity across shards (a merge deep inside one slab is
invisible to its neighbor), and exactly as in the distributed fit every
such divergence is witnessed by a shared core point near a cut: the
re-reconciliation pass walks the shared copies adjacent to the touched
shards and unions their label pairs into the global label map (edges
only at genuinely core shared points -- border labels are
order-dependent and must never stitch clusters).  Read-outs and
predictions resolve raw per-shard labels through the map.

**Delete.**  A delete removes a point's authoritative copy *and* every
ghost copy in one call, so each shard's local state stays
self-consistently exact (the same invariant insert maintains); the
shard-local removals run through the delta engine
(``repro_torch.index.delta``), which handles demotions, merge-edge loss and
component splits per shard.  Cross-shard identity can now *split* --
a union-only map cannot express that -- so after a delete the global
``LabelMap`` is **rebuilt from the surviving shared-core witness
edges**: exactly the pairs the incremental pass would union, collected
over every boundary registry.  Any cross-shard connection that
survived the delete is still witnessed by a shared core near a cut
(the fit-time argument, unchanged), so the rebuilt map is exhaustive;
anything no longer witnessed falls apart into the per-shard components
the delta engine already split.  The registries are boundary-sized, so
the rebuild costs O(ghost copies), not O(n).

**Topology ops** (split / merge).  The slab partition itself is
mutable: :meth:`split_shard` re-cuts one slab at a fresh interior
grid line and :meth:`merge_shards` concatenates two adjacent slabs --
the load-adaptive rebalancing primitive (``repro_torch.dist.rebalance``).
Both are *pure re-partitions of existing physical copies*: shard k's
own points plus its ghost band cover every sub-slab's coverage
([sub - 2eps, sub + 2eps) ⊂ [slab - 2eps, slab + 2eps)), so the new
shard(s) are built by ``GritIndex.from_fit`` over the pooled copies
with their *canonical* (map-resolved) labels and owner-exact core
flags -- no distance work, no identity change.  Cross-shard identity
is then re-derived by the same witness-edge map rebuild the delete
path uses: exhaustive in the insert-only regime because witnesses only
accumulate (so read-outs stay **bit-identical**), and exhaustive under
the localization invariant otherwise (the new shards re-mint per local
component, so the partition is preserved while ids may re-mint, same
as any delete).  Every op is recorded in ``cut_history`` (snapshot v3).

**Mutation log.**  ``enable_mutation_log()`` attaches a
:class:`~repro_torch.index.delta.MutationLog`: every top-level insert /
delete / topology batch is appended verbatim, and ``ops_applied`` is
the replay cursor a read-only
:class:`~repro_torch.index.replica.ReplicaIndex` catches up from.
The delta engine is deterministic, so a replica that cloned this
index's snapshot and replayed the log serves ``predict``
bit-identically to the primary.

**Devices.**  The index is host numpy over the port's per-shard
:class:`~repro_torch.index.GritIndex`; ``predict`` and
:func:`fit_sharded` take the ``device=`` of ``GritIndex.predict`` and
pass it on to every shard (``None`` is the CUDA device, ``"cpu"`` runs
the kernels' plain versions).  Snapshots use the reference's ``.npz``
layout (v3), so a snapshot written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..dist.sharding import owner_of_slab, slab_cuts

from .delta import MutationLog
from .grit_index import GritIndex
from .snapshot_io import check_version, load_snapshot, save_snapshot

# v2 carries deletions (tombstoned global ids appear as owner_shard ==
# -1 and the per-shard sub-snapshots are v2); v3 adds the topology-op
# cut history and the mutation-log cursor (``ops_applied``); v1/v2
# snapshots restore unchanged (empty history, cursor 0).
_SHARDED_SNAPSHOT_VERSION = 3
_SHARDED_ACCEPTED = (1, 2, 3)


class LabelMap:
    """Union-find over global cluster ids (root = smallest id).

    The global label map of the sharded index: per-shard labels stay
    raw; merges discovered by cross-shard reconciliation only touch
    this map, so re-reconciliation never rewrites per-shard arrays.
    """

    def __init__(self, n: int, parent: Optional[np.ndarray] = None):
        self.parent = (np.arange(n, dtype=np.int64) if parent is None
                       else np.asarray(parent, np.int64).copy())

    def __len__(self) -> int:
        return len(self.parent)

    def grow(self, n: int) -> None:
        if n > len(self.parent):
            self.parent = np.concatenate(
                [self.parent,
                 np.arange(len(self.parent), n, dtype=np.int64)])

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:            # path compression
            p[x], x = root, p[x]
        return int(root)

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if rb < ra:                    # smallest id wins: deterministic
            ra, rb = rb, ra
        self.parent[rb] = ra
        return True

    def resolve(self, labels: np.ndarray) -> np.ndarray:
        """Map raw labels to canonical roots (vectorized; -1 passes)."""
        lab = np.asarray(labels, np.int64)
        out = lab.copy()
        m = lab >= 0
        cur = out[m]
        while True:
            nxt = self.parent[cur]
            if np.array_equal(nxt, cur):
                break
            cur = nxt
        out[m] = cur
        return out


@dataclasses.dataclass
class ShardedGritIndex:
    """Per-slab ``GritIndex`` shards + the global label map.

    Bookkeeping (all arrival-order):

    * ``own_rows[k]`` / ``own_gids[k]`` -- shard k's rows that are
      *owned* points, and the global arrival index of each (the
      original point order of the fit, inserts appended);
    * ``ghost_rows[k]`` / ``ghost_gids[k]`` -- shard k's ghost copies
      and the global ids they duplicate (the shared-point registry the
      re-reconciliation walks);
    * ``owner_shard`` / ``owner_row`` -- for every global id, where its
      authoritative (owner) copy lives.
    """

    shards: List[GritIndex]
    cuts: np.ndarray               # [K-1] float64 dim-0 slab boundaries
    eps: float
    min_pts: int
    next_label: int                # shared fresh-cluster-id sequence
    label_map: LabelMap
    own_rows: List[np.ndarray]
    own_gids: List[np.ndarray]
    ghost_rows: List[np.ndarray]
    ghost_gids: List[np.ndarray]
    owner_shard: np.ndarray        # [n] int64 (-1 = deleted)
    owner_row: np.ndarray          # [n] int64
    # True once per-shard labels are per-local-component with disjoint
    # arenas (the invariant deletion needs; see _ensure_localized)
    localized: bool = False
    # Topology-op provenance: ("split" | "merge", shard, cut coordinate)
    # in application order.  Snapshot v3 carries it (with the mutation-
    # log cursor below), so a restored index knows how its cuts evolved
    # from the fit-time partition.
    cut_history: List[Tuple[str, int, float]] = dataclasses.field(
        default_factory=list)
    # Replication plane: ops_applied counts the top-level mutation /
    # topology batches absorbed (the replica replay cursor, snapshot
    # v3); the attached log itself is runtime state, never snapshotted.
    ops_applied: int = 0
    mutation_log: Optional[MutationLog] = dataclasses.field(
        default=None, repr=False, compare=False)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def from_global_fit(cls, points, eps: float, min_pts: int, labels,
                        core=None, n_shards: int = 4
                        ) -> "ShardedGritIndex":
        """Shard one finished global fit (arrival-order labels/core).

        ``labels`` must be globally reconciled cluster ids (what the
        distributed engine returns); ``core`` the exact global core
        flags (``None`` falls back to per-shard grid-based
        identification -- exact for owned points, whose neighborhoods
        are complete per shard).  Slabs are cut on grid lines along
        dim 0 (the distributed fit's partition); empty slabs are
        coalesced into their neighbor, so every shard is non-empty.
        """
        pts = np.asarray(points, np.float64)
        n, _ = pts.shape
        labels = np.asarray(labels, np.int64)
        core = None if core is None else np.asarray(core, bool)
        _, _, cut_coords = slab_cuts(pts, eps, max(int(n_shards), 1))
        cuts = np.asarray(cut_coords, np.float64)
        cuts = np.unique(cuts[np.isfinite(cuts)])
        owner = owner_of_slab(pts[:, 0], cuts)
        present = np.unique(owner)
        if len(present) < len(cuts) + 1:
            # drop cuts bounding empty slabs: the boundary between two
            # consecutive *present* slabs is the left edge of the later
            cuts = np.asarray([cuts[b - 1] for b in present[1:]],
                              np.float64)
            owner = owner_of_slab(pts[:, 0], cuts)
        K = len(cuts) + 1
        band = 2.0 * float(eps)
        x0 = pts[:, 0]
        shards, own_rows, own_gids = [], [], []
        ghost_rows, ghost_gids = [], []
        owner_row = np.empty(n, np.int64)
        for k in range(K):
            lo = cuts[k - 1] if k > 0 else -np.inf
            hi = cuts[k] if k < K - 1 else np.inf
            own_sel = owner == k
            ghost_sel = (~own_sel) & (x0 >= lo - band) & (x0 < hi + band)
            oidx = np.flatnonzero(own_sel)
            gidx = np.flatnonzero(ghost_sel)
            sel = np.concatenate([oidx, gidx])
            shards.append(GritIndex.from_fit(
                pts[sel], eps, min_pts, labels=labels[sel],
                core=None if core is None else core[sel]))
            own_rows.append(np.arange(len(oidx), dtype=np.int64))
            own_gids.append(oidx)
            ghost_rows.append(len(oidx) + np.arange(len(gidx),
                                                    dtype=np.int64))
            ghost_gids.append(gidx)
            owner_row[oidx] = np.arange(len(oidx), dtype=np.int64)
        next_label = int(labels.max(initial=-1)) + 1
        return cls(shards=shards, cuts=cuts, eps=float(eps),
                   min_pts=int(min_pts), next_label=next_label,
                   label_map=LabelMap(next_label), own_rows=own_rows,
                   own_gids=own_gids, ghost_rows=ghost_rows,
                   ghost_gids=ghost_gids,
                   owner_shard=owner.astype(np.int64),
                   owner_row=owner_row)

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------

    @property
    def n(self) -> int:
        """Global ids ever assigned (deleted ids included -- ids are
        never reused, so this is also the next fresh id)."""
        return int(len(self.owner_shard))

    @property
    def n_live(self) -> int:
        """Surviving owned points (each physical point counted once)."""
        return int((self.owner_shard >= 0).sum())

    @property
    def d(self) -> int:
        return self.shards[0].d

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def num_grids(self) -> int:
        """Total non-empty grids over all shards (ghost bands double-
        count boundary grids -- a capacity figure, not a partition)."""
        return int(sum(s.num_grids for s in self.shards))

    def _slab_bounds(self, k: int):
        lo = self.cuts[k - 1] if k > 0 else -np.inf
        hi = self.cuts[k] if k < self.num_shards - 1 else np.inf
        return lo, hi

    def labels_arrival(self) -> np.ndarray:
        """Canonical labels of the *live* points in global arrival
        order (fit order, inserts appended, deleted ids omitted) --
        per-shard raw labels resolved through the map."""
        out = np.full(self.n, -1, np.int64)
        for k, idx in enumerate(self.shards):
            out[self.own_gids[k]] = idx.labels_at(self.own_rows[k])
        return self.label_map.resolve(out[self.owner_shard >= 0])

    def core_arrival(self) -> np.ndarray:
        """Core flags of the live points in global arrival order
        (owner copies: exact)."""
        out = np.zeros(self.n, bool)
        for k, idx in enumerate(self.shards):
            out[self.own_gids[k]] = idx.core_at(self.own_rows[k])
        return out[self.owner_shard >= 0]

    def arrival_live(self) -> np.ndarray:
        """Sorted global ids of the surviving points (what
        :meth:`labels_arrival` rows correspond to)."""
        return np.flatnonzero(self.owner_shard >= 0)

    # ------------------------------------------------------------------
    # mutation log (replica replay)
    # ------------------------------------------------------------------

    def enable_mutation_log(self) -> MutationLog:
        """Attach (or return) the replication log.

        From this call on, every top-level :meth:`insert` /
        :meth:`delete` / topology batch is appended verbatim; the log
        base is the current :attr:`ops_applied`, so a replica cloned
        from a snapshot taken *now* starts exactly at the log base."""
        if self.mutation_log is None:
            self.mutation_log = MutationLog(base=self.ops_applied)
        return self.mutation_log

    def _log_mutation(self, op: str, payload: np.ndarray) -> None:
        self.ops_applied += 1
        if self.mutation_log is not None:
            self.mutation_log.append(op, payload)

    # ------------------------------------------------------------------
    # predict
    # ------------------------------------------------------------------

    def predict(self, queries, *, mode: str = "auto", chunk: int = 2048,
                stats: Optional[dict] = None, device=None) -> np.ndarray:
        """Slab-routed exact predict (see module docstring).

        Buckets queries by owning slab, consults the adjacent shard(s)
        for queries within ``2 * eps`` of a cut, runs *one* batched
        per-shard predict per consulted shard, and combines by nearest
        core (owner priority on exact ties).  ``mode`` and ``device``
        go to every shard's ``GritIndex.predict``.  Returns [m] int64
        canonical labels; -1 noise.
        """
        q = np.asarray(queries, np.float64)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(
                f"queries must be [m, {self.d}], got {q.shape}")
        if q.shape[0] == 0:
            return np.empty(0, np.int64)
        if not np.isfinite(q).all():
            raise ValueError("queries contain non-finite coordinates")
        m = q.shape[0]
        x0 = q[:, 0]
        owner = owner_of_slab(x0, self.cuts)
        band = 2.0 * self.eps
        out = np.full(m, -1, np.int64)
        best_d2 = np.full(m, np.inf, np.float64)
        per_shard: List[int] = []
        consulted = 0
        shard_mode = None
        for k in range(self.num_shards):
            lo, hi = self._slab_bounds(k)
            sel = np.flatnonzero((x0 >= lo - band) & (x0 < hi + band))
            per_shard.append(int(len(sel)))
            if len(sel) == 0:
                continue
            pstats: Dict[str, Any] = {}
            lab_k, d2_k = self.shards[k].predict(
                q[sel], mode=mode, chunk=chunk, stats=pstats,
                return_d2=True, device=device)
            shard_mode = pstats.get("mode", shard_mode)
            consulted += len(sel)
            is_owner = owner[sel] == k
            # the owner's answer is exact; a neighbor may only confirm
            # (strict improvement is impossible -- defensively allowed)
            take = is_owner | (d2_k < best_d2[sel])
            rows = sel[take]
            out[rows] = lab_k[take]
            best_d2[rows] = d2_k[take]
        if stats is not None:
            owned = np.bincount(owner, minlength=self.num_shards)
            stats.update(
                mode=shard_mode, n_queries=m,
                shards=self.num_shards, consulted=consulted,
                multi_routed=int(consulted - m),
                per_shard=per_shard,
                owned_per_shard=[int(c) for c in owned])
        return self.label_map.resolve(out)

    # ------------------------------------------------------------------
    # insert
    # ------------------------------------------------------------------

    _SUMMED = ("touched_grids", "affected_grids", "changed_grids",
               "merge_checks", "dist_evals", "relabeled")

    def insert(self, batch) -> Dict[str, Any]:
        """Micro-batch insert confined to the touched shards.

        Buckets by owning slab, splices each sub-batch into its owner
        shard (plus ghost copies into neighbors whose band contains the
        point), then re-reconciles cluster identity over the shared
        points adjacent to the touched shards (module docstring).

        Returns the **unified mutation stats schema** -- the same keys
        as ``GritIndex.insert`` (see
        :func:`repro_torch.index.delta.insert_batch`), with the per-grid /
        per-eval counters summed over the touched shards,
        ``newly_core`` deduplicated to owned copies, and ``id_shifted``
        true if any shard translated its lattice.  Sharded extras:
        ``shards_touched``, ``reconcile_unions`` and ``per_shard``
        (the raw per-shard breakdowns).
        """
        t0 = time.perf_counter()
        B = np.asarray(batch, np.float64)
        if B.ndim != 2 or B.shape[1] != self.d:
            raise ValueError(f"insert batch must be [m, {self.d}], "
                             f"got {B.shape}")
        m = B.shape[0]
        if m == 0:
            return {"op": "insert", "inserted": 0, "n": self.n,
                    "n_live": self.n_live,
                    **{f: 0 for f in self._SUMMED},
                    "newly_core": 0, "id_shifted": False,
                    "shards_touched": [], "reconcile_unions": 0,
                    "per_shard": [],
                    "t_total": time.perf_counter() - t0}
        if not np.isfinite(B).all():
            raise ValueError("insert batch contains non-finite "
                             "coordinates")
        x0 = B[:, 0]
        owner = owner_of_slab(x0, self.cuts)
        gid0 = self.n
        band = 2.0 * self.eps
        owner_row_new = np.empty(m, np.int64)
        touched: List[int] = []
        per_shard: List[Dict[str, Any]] = []
        for k in range(self.num_shards):
            lo, hi = self._slab_bounds(k)
            own_sel = owner == k
            ghost_sel = (~own_sel) & (x0 >= lo - band) & (x0 < hi + band)
            if not (own_sel.any() or ghost_sel.any()):
                continue
            oidx = np.flatnonzero(own_sel)
            gidx = np.flatnonzero(ghost_sel)
            shard = self.shards[k]
            # the delta engine assigns shard-local arrival ids from
            # next_arrival (NOT from n: after a delete + compaction the
            # two diverge, ids are never reused)
            n_before = shard.next_arrival
            # fresh cluster ids come from the shared global sequence,
            # so two shards can never mint the same id
            shard.next_label = self.next_label
            st = shard.insert(B[np.concatenate([oidx, gidx])])
            self.next_label = shard.next_label
            rows = n_before + np.arange(len(oidx) + len(gidx),
                                        dtype=np.int64)
            self.own_rows[k] = np.concatenate(
                [self.own_rows[k], rows[:len(oidx)]])
            self.own_gids[k] = np.concatenate(
                [self.own_gids[k], gid0 + oidx])
            self.ghost_rows[k] = np.concatenate(
                [self.ghost_rows[k], rows[len(oidx):]])
            self.ghost_gids[k] = np.concatenate(
                [self.ghost_gids[k], gid0 + gidx])
            owner_row_new[oidx] = rows[:len(oidx)]
            touched.append(k)
            # count promotions on owned copies only -- a shared (ghost)
            # copy is promoted in every shard that holds it, and summing
            # raw per-shard counts would double-count those points
            nc_own = int((~np.isin(st["newly_core_arrival"],
                                   self.ghost_rows[k])).sum())
            per_shard.append({
                "shard": k, "own": int(len(oidx)),
                "ghost": int(len(gidx)), "newly_core_own": nc_own,
                "newly_core": st["newly_core"],
                "id_shifted": st["id_shifted"],
                **{f: st[f] for f in self._SUMMED}})
        self.owner_shard = np.concatenate([self.owner_shard, owner])
        self.owner_row = np.concatenate([self.owner_row, owner_row_new])
        self.label_map.grow(self.next_label)
        unions = self._reconcile(touched)
        self._log_mutation("insert", B)
        return {"op": "insert", "inserted": m, "n": self.n,
                "n_live": self.n_live,
                **{f: sum(s[f] for s in per_shard)
                   for f in self._SUMMED},
                "newly_core": int(sum(s["newly_core_own"]
                                      for s in per_shard)),
                "id_shifted": any(s["id_shifted"] for s in per_shard),
                "shards_touched": touched,
                "reconcile_unions": unions, "per_shard": per_shard,
                "t_total": time.perf_counter() - t0}

    def _reconcile(self, touched: List[int]) -> int:
        """Incremental edge re-reconciliation over shared points.

        For every ghost copy in (or owned by) a touched shard whose
        authoritative copy is core, union the two copies' raw labels in
        the global map.  Core witnesses only: a non-core shared point's
        border labels are legitimately order-dependent and must never
        merge clusters.
        """
        if not touched:
            return 0
        return self._union_witness_edges(self.label_map, set(touched))

    def _union_witness_edges(self, lm: LabelMap,
                             touched: Optional[set] = None) -> int:
        """Union every surviving shared-core witness pair into ``lm``.

        The one enumeration both reconciliation directions share: walk
        the ghost registries, and for every ghost copy whose
        authoritative (owner) copy is core and both copies carry
        labels, union the (owner label, ghost label) pair.  Core
        witnesses only -- border labels are order-dependent and must
        never stitch clusters.  ``touched`` restricts the walk to
        ghosts in (or owned by) those shards -- insert's incremental
        patch; ``None`` walks every registry -- delete's rebuild.
        Returns the union count.
        """
        unions = 0
        for k, shard in enumerate(self.shards):
            gg = self.ghost_gids[k]
            if len(gg) == 0:
                continue
            own_s = self.owner_shard[gg]
            if touched is None or k in touched:
                mask = np.ones(len(gg), bool)
            else:
                mask = np.isin(own_s, np.asarray(sorted(touched)))
            if not mask.any():
                continue
            glab = shard.labels_at(self.ghost_rows[k][mask])
            gid = gg[mask]
            own_s = own_s[mask]
            for o in np.unique(own_s):
                sel = own_s == o
                orow = self.owner_row[gid[sel]]
                olab = self.shards[int(o)].labels_at(orow)
                ocore = self.shards[int(o)].core_at(orow)
                ok = ocore & (olab >= 0) & (glab[sel] >= 0) \
                    & (olab != glab[sel])
                for a, b in zip(olab[ok], glab[sel][ok]):
                    unions += lm.union(int(a), int(b))
        return int(unions)

    # ------------------------------------------------------------------
    # delete
    # ------------------------------------------------------------------

    def _ensure_localized(self) -> None:
        """Re-mint per-shard labels as per-local-component ids (once).

        A global fit hands every shard the *global* cluster ids, which
        is fine for insert-only traffic (components only ever merge,
        and the union-only map absorbs that).  Deletion breaks it: a
        raw id shared by two shards -- or spanning two locally
        disconnected pieces whose connection runs through a third
        shard's coverage -- cannot be split by any label *map* once the
        connection is severed, because both uses resolve through the
        same id.  So before the first delete, every shard re-mints its
        labels per local merge-graph component from the shared fresh
        sequence (arenas disjoint forever after), and cross-shard
        identity moves entirely into the witness-edge map, where a
        rebuild CAN express splits.  A pure rename: the read-out
        partition is unchanged.  Mutations maintain the invariant
        inductively (insert merges keep one id per component; delete
        splits mint fresh ids for the non-keeper sides).
        """
        if self.localized:
            return
        from .delta import relabel_local_components
        for shard in self.shards:
            shard.next_label = self.next_label
            relabel_local_components(shard)
            self.next_label = shard.next_label
        self.localized = True
        self._rebuild_label_map()

    def delete(self, arrival_ids) -> Dict[str, Any]:
        """Exactly remove points by global arrival id, across shards.

        Every physical copy goes at once -- the owner copy and each
        ghost copy in a neighbor's band -- so per-shard local state
        stays self-consistently exact; shard-local removal runs through
        the delta engine (demotions, merge-edge loss, component
        splits, threshold compaction).  Because deletion can *split*
        cross-shard clusters, the global label map is then rebuilt from
        the surviving shared-core witness edges (module docstring),
        not union-patched.

        Unknown / already-deleted ids are rejected (reported, not
        raised).  Returns the unified mutation stats schema with
        ``op="delete"`` (per-grid counters shard-summed, ``demoted``
        deduplicated to owned copies) plus ``rejected`` /
        ``rejected_ids``, ``shards_touched``, ``reconcile_unions``
        (unions in the rebuilt map) and ``per_shard``.
        """
        t0 = time.perf_counter()
        self._ensure_localized()
        ids = np.unique(np.asarray(arrival_ids, np.int64).ravel())
        valid = (ids >= 0) & (ids < self.n)
        valid[valid] = self.owner_shard[ids[valid]] >= 0
        gids, rejected = ids[valid], ids[~valid]
        kill = np.zeros(self.n, bool)
        kill[gids] = True
        touched: List[int] = []
        per_shard: List[Dict[str, Any]] = []
        for k, shard in enumerate(self.shards):
            own_m = kill[self.own_gids[k]]
            ghost_m = kill[self.ghost_gids[k]]
            if not (own_m.any() or ghost_m.any()):
                continue
            shard.next_label = self.next_label
            st = shard.delete(np.concatenate(
                [self.own_rows[k][own_m], self.ghost_rows[k][ghost_m]]))
            self.next_label = shard.next_label
            # count demotions on owned copies only -- a shared (ghost)
            # copy demotes in every shard holding it, and summing raw
            # per-shard counts would double-count (same dedupe as
            # insert's newly_core)
            demoted_own = int((~np.isin(st["demoted_arrival"],
                                        self.ghost_rows[k])).sum())
            self.own_rows[k] = self.own_rows[k][~own_m]
            self.own_gids[k] = self.own_gids[k][~own_m]
            self.ghost_rows[k] = self.ghost_rows[k][~ghost_m]
            self.ghost_gids[k] = self.ghost_gids[k][~ghost_m]
            touched.append(k)
            per_shard.append({
                "shard": k, "own": int(own_m.sum()),
                "ghost": int(ghost_m.sum()),
                "deleted": st["deleted"], "demoted": st["demoted"],
                "demoted_own": demoted_own,
                "compacted": st["compacted"],
                **{f: st[f] for f in self._SUMMED}})
        self.owner_shard[gids] = -1
        self.owner_row[gids] = -1
        unions = self._rebuild_label_map()
        self._log_mutation("delete", ids)
        return {"op": "delete", "requested": int(len(ids)),
                "deleted": int(len(gids)),
                "rejected": int(len(rejected)), "rejected_ids": rejected,
                "n": self.n, "n_live": self.n_live,
                **{f: sum(s[f] for s in per_shard)
                   for f in self._SUMMED},
                "demoted": int(sum(s["demoted_own"] for s in per_shard)),
                "compacted": any(s["compacted"] for s in per_shard),
                "shards_touched": touched,
                "reconcile_unions": unions, "per_shard": per_shard,
                "t_total": time.perf_counter() - t0}

    def _rebuild_label_map(self) -> int:
        """Reconstruct the global map from surviving witness edges.

        The delete-direction twin of :meth:`_reconcile`: instead of
        union-patching (which cannot express a split), start from a
        fresh identity map over the shared ``next_label`` arena and
        union exactly the (owner label, ghost label) pairs still
        witnessed by a core shared point.  Returns the union count.
        """
        lm = LabelMap(self.next_label)
        unions = self._union_witness_edges(lm)
        self.label_map = lm
        return unions

    # ------------------------------------------------------------------
    # topology ops (split / merge -- see module docstring)
    # ------------------------------------------------------------------

    def _copy_state(self, k: int):
        """Every physical copy shard k holds (own block first, then
        ghosts): global ids, coordinates, *canonical* (map-resolved)
        labels and owner-exact core flags -- the pooled state a
        topology op re-partitions.  Labels and core flags come from the
        authoritative (owner) copy of each point, so they are exact for
        ghosts too."""
        shard = self.shards[k]
        gids = np.concatenate([self.own_gids[k], self.ghost_gids[k]])
        arr = np.concatenate([self.own_rows[k], self.ghost_rows[k]])
        # registries are pruned on delete, so every registered copy is
        # live and rows_of_arrival cannot return -1 here
        pts = shard.points[shard.rows_of_arrival(arr)]
        labels = np.full(len(gids), -1, np.int64)
        core = np.zeros(len(gids), bool)
        own_s = self.owner_shard[gids]
        for o in np.unique(own_s):
            sel = own_s == o
            orow = self.owner_row[gids[sel]]
            labels[sel] = self.shards[int(o)].labels_at(orow)
            core[sel] = self.shards[int(o)].core_at(orow)
        return gids, pts, self.label_map.resolve(labels), core

    def _install_shards(self, k: int, j: int, subs, pools) -> None:
        """Replace shards ``k..j`` with ``subs`` (built from ``pools``
        of (gids, oidx, gidx) selections): splice the shard list and
        registries, rewrite the owner router, re-localize the new
        shards when the localization invariant is on, and rebuild the
        global map from the surviving witness edges."""
        delta_k = len(subs) - (j - k + 1)
        shift = self.owner_shard > j
        self.shards[k:j + 1] = subs
        self.own_rows[k:j + 1] = [np.arange(len(oidx), dtype=np.int64)
                                  for _, oidx, _ in pools]
        self.own_gids[k:j + 1] = [gids[oidx] for gids, oidx, _ in pools]
        self.ghost_rows[k:j + 1] = [
            len(oidx) + np.arange(len(gidx), dtype=np.int64)
            for _, oidx, gidx in pools]
        self.ghost_gids[k:j + 1] = [gids[gidx] for gids, _, gidx in pools]
        # router: shift the shards beyond the spliced range first (the
        # -1 tombstones are excluded by the > j mask), then point the
        # re-partitioned owners at their new shard / arrival id
        self.owner_shard[shift] += delta_k
        for h, (gids, oidx, _) in enumerate(pools):
            og = gids[oidx]
            self.owner_shard[og] = k + h
            self.owner_row[og] = np.arange(len(oidx), dtype=np.int64)
        if self.localized:
            # the sub-shards carry canonical labels; re-mint per local
            # component so the localization invariant (one raw label ==
            # one local component, disjoint arenas) survives the op
            from .delta import relabel_local_components
            for sub in subs:
                sub.next_label = self.next_label
                relabel_local_components(sub)
                self.next_label = sub.next_label

    def split_shard(self, k: int) -> Dict[str, Any]:
        """Split shard ``k`` at a fresh interior grid-line cut.

        The cut comes from :func:`repro_torch.dist.sharding.slab_cuts` over
        the slab's *own* points (the same equal-count-on-grid-lines
        policy as the fit-time partition), so both halves are
        non-empty; a slab whose own points share a single dim-0 grid
        column has no interior grid line and raises ``ValueError``
        (the caller -- e.g. the rebalancer -- treats that slab as
        unsplittable).  Pure re-partition of existing physical copies:
        read-outs are bit-identical in the insert-only regime and
        partition-identical under localization (module docstring).

        Returns an op-stats dict (``op="split"``, the new ``cut``, the
        two half sizes, ``reconcile_unions`` of the map rebuild).
        """
        t0 = time.perf_counter()
        K = self.num_shards
        if not 0 <= k < K:
            raise ValueError(f"split_shard: no shard {k} (have {K})")
        lo, hi = self._slab_bounds(k)
        n_own = len(self.own_gids[k])
        gids, pts, labels, core = self._copy_state(k)
        if n_own >= 2:
            _, cut_idx, cut_coords = slab_cuts(pts[:n_own], self.eps, 2)
        if n_own < 2 or not np.isfinite(cut_coords[0]) \
                or not 0 < int(cut_idx[0]) < n_own:
            raise ValueError(
                f"split_shard({k}): slab has no interior grid-line cut "
                f"({n_own} own points"
                + ("" if n_own < 2 else " in one dim-0 grid column")
                + "); shard is unsplittable")
        c = float(cut_coords[0])
        band = 2.0 * self.eps
        x0 = pts[:, 0]
        is_own = np.zeros(len(gids), bool)
        is_own[:n_own] = True
        subs, pools = [], []
        for slo, shi in ((lo, c), (c, hi)):
            own_sel = is_own & (x0 >= slo) & (x0 < shi)
            ghost_sel = (~own_sel) & (x0 >= slo - band) & (x0 < shi + band)
            oidx = np.flatnonzero(own_sel)
            gidx = np.flatnonzero(ghost_sel)
            sel = np.concatenate([oidx, gidx])
            sub = GritIndex.from_fit(
                pts[sel], self.eps, self.min_pts, labels=labels[sel],
                core=core[sel])
            # eager: a topology op is amortized by the rebalance period,
            # so the merge-graph build belongs here, not in the first
            # serving-path insert to touch the fresh shard
            sub.ensure_merge_graph()
            subs.append(sub)
            pools.append((gids, oidx, gidx))
        self.cuts = np.concatenate(
            [self.cuts[:k], np.asarray([c], np.float64), self.cuts[k:]])
        self._install_shards(k, k, subs, pools)
        unions = self._rebuild_label_map()
        self.cut_history.append(("split", int(k), c))
        self._log_mutation("split", np.asarray([k], np.int64))
        return {"op": "split", "shard": int(k), "cut": c,
                "n_left": int(len(pools[0][1])),
                "n_right": int(len(pools[1][1])),
                "num_shards": self.num_shards,
                "reconcile_unions": unions,
                "t_total": time.perf_counter() - t0}

    def merge_shards(self, k: int, j: Optional[int] = None
                     ) -> Dict[str, Any]:
        """Merge adjacent shards ``k`` and ``k + 1`` (the split
        inverse): pool both shards' physical copies (deduplicated by
        global id -- a point can be own in one and ghost in the other),
        build one shard over the union slab, drop the cut between
        them.  Pure re-partition, same exactness contract as
        :meth:`split_shard`.

        Returns an op-stats dict (``op="merge"``, the ``cut`` removed,
        the merged size, ``reconcile_unions`` of the map rebuild).
        """
        t0 = time.perf_counter()
        K = self.num_shards
        if j is None:
            j = k + 1
        if j != k + 1 or not 0 <= k < j < K:
            raise ValueError(
                f"merge_shards: need adjacent shards (k, k+1) within "
                f"0..{K - 1}, got ({k}, {j})")
        lo, _ = self._slab_bounds(k)
        _, hi = self._slab_bounds(j)
        removed = float(self.cuts[k])
        g0, p0, l0, c0 = self._copy_state(k)
        g1, p1, l1, c1 = self._copy_state(j)
        gids = np.concatenate([g0, g1])
        # dedupe to one physical copy per global id (ghost copies are
        # verbatim splices of the owner's coordinates, so any copy is
        # authoritative for the pooled build)
        gids, first = np.unique(gids, return_index=True)
        pts = np.concatenate([p0, p1])[first]
        labels = np.concatenate([l0, l1])[first]
        core = np.concatenate([c0, c1])[first]
        band = 2.0 * self.eps
        x0 = pts[:, 0]
        own_sel = np.isin(self.owner_shard[gids], (k, j))
        ghost_sel = (~own_sel) & (x0 >= lo - band) & (x0 < hi + band)
        oidx = np.flatnonzero(own_sel)
        gidx = np.flatnonzero(ghost_sel)
        sel = np.concatenate([oidx, gidx])
        sub = GritIndex.from_fit(pts[sel], self.eps, self.min_pts,
                                 labels=labels[sel], core=core[sel])
        sub.ensure_merge_graph()  # charge the build to the amortized op
        self.cuts = np.concatenate([self.cuts[:k], self.cuts[k + 1:]])
        self._install_shards(k, j, [sub], [(gids, oidx, gidx)])
        unions = self._rebuild_label_map()
        self.cut_history.append(("merge", int(k), removed))
        self._log_mutation("merge", np.asarray([k], np.int64))
        return {"op": "merge", "shard": int(k), "cut": removed,
                "n_merged": int(len(oidx)),
                "num_shards": self.num_shards,
                "reconcile_unions": unions,
                "t_total": time.perf_counter() - t0}

    # ------------------------------------------------------------------
    # snapshot / restore
    # ------------------------------------------------------------------

    def snapshot(self) -> Dict[str, np.ndarray]:
        """Flat-array serialization: per-shard ``GritIndex`` snapshots
        (key-prefixed) + the routing/reconciliation state.  Directly
        ``np.savez``-able, like the single-shard snapshot."""
        snap: Dict[str, np.ndarray] = {
            "sharded_version": np.asarray([_SHARDED_SNAPSHOT_VERSION],
                                          np.int64),
            "cuts": np.asarray(self.cuts, np.float64),
            "scalars_f": np.asarray([self.eps], np.float64),
            "scalars_i": np.asarray(
                [self.min_pts, self.next_label, self.num_shards,
                 int(self.localized), self.ops_applied], np.int64),
            "label_parent": self.label_map.parent.copy(),
            "owner_shard": self.owner_shard.copy(),
            "owner_row": self.owner_row.copy(),
            # v3: topology-op provenance (kind 0=split, 1=merge)
            "cut_hist_kind": np.asarray(
                [0 if op == "split" else 1
                 for op, _, _ in self.cut_history], np.int64),
            "cut_hist_shard": np.asarray(
                [s for _, s, _ in self.cut_history], np.int64),
            "cut_hist_coord": np.asarray(
                [c for _, _, c in self.cut_history], np.float64),
        }
        for k, idx in enumerate(self.shards):
            for key, v in idx.snapshot().items():
                snap[f"shard{k}.{key}"] = v
            snap[f"shard{k}.own_rows"] = self.own_rows[k].copy()
            snap[f"shard{k}.own_gids"] = self.own_gids[k].copy()
            snap[f"shard{k}.ghost_rows"] = self.ghost_rows[k].copy()
            snap[f"shard{k}.ghost_gids"] = self.ghost_gids[k].copy()
        return snap

    _EXTRA = ("own_rows", "own_gids", "ghost_rows", "ghost_gids")

    @classmethod
    def restore(cls, snap: Dict[str, np.ndarray]) -> "ShardedGritIndex":
        check_version(snap, "sharded_version", _SHARDED_ACCEPTED,
                      "sharded snapshot")
        sf = np.asarray(snap["scalars_f"], np.float64)
        si = np.asarray(snap["scalars_i"], np.int64)
        K = int(si[2])
        shards, own_rows, own_gids, ghost_rows, ghost_gids = \
            [], [], [], [], []
        for k in range(K):
            prefix = f"shard{k}."
            sub = {key[len(prefix):]: v for key, v in snap.items()
                   if key.startswith(prefix)
                   and key[len(prefix):] not in cls._EXTRA}
            shards.append(GritIndex.restore(sub))
            own_rows.append(np.asarray(snap[f"shard{k}.own_rows"],
                                       np.int64))
            own_gids.append(np.asarray(snap[f"shard{k}.own_gids"],
                                       np.int64))
            ghost_rows.append(np.asarray(snap[f"shard{k}.ghost_rows"],
                                         np.int64))
            ghost_gids.append(np.asarray(snap[f"shard{k}.ghost_gids"],
                                         np.int64))
        # v1/v2 snapshots carry no topology history or replay cursor
        hist: List[Tuple[str, int, float]] = []
        if "cut_hist_kind" in snap:
            hist = [("split" if int(kk) == 0 else "merge", int(s),
                     float(c))
                    for kk, s, c in zip(snap["cut_hist_kind"],
                                        snap["cut_hist_shard"],
                                        snap["cut_hist_coord"])]
        return cls(shards=shards,
                   cuts=np.asarray(snap["cuts"], np.float64),
                   eps=float(sf[0]), min_pts=int(si[0]),
                   next_label=int(si[1]),
                   label_map=LabelMap(int(si[1]),
                                      parent=snap["label_parent"]),
                   own_rows=own_rows, own_gids=own_gids,
                   ghost_rows=ghost_rows, ghost_gids=ghost_gids,
                   owner_shard=np.asarray(snap["owner_shard"], np.int64),
                   owner_row=np.asarray(snap["owner_row"], np.int64),
                   localized=bool(si[3]) if len(si) > 3 else False,
                   cut_history=hist,
                   ops_applied=int(si[4]) if len(si) > 4 else 0)

    def save(self, path) -> None:
        save_snapshot(path, self.snapshot())

    @classmethod
    def load(cls, path) -> "ShardedGritIndex":
        return cls.restore(load_snapshot(path))


def fit_sharded(points, eps: float, min_pts: int, *,
                n_shards: Optional[int] = None, devices=None,
                engine: Optional[str] = None, device=None,
                **opts) -> ShardedGritIndex:
    """Fit and shard in one call: distributed fit -> ShardedGritIndex.

    With ``devices`` (one torch device per fit shard, the counterpart
    of the reference's ``mesh``), the fit runs the distributed engine
    on them (the adaptive-cap loop included) and the slab count
    follows their number unless ``n_shards`` says otherwise.  With
    ``engine="distributed"`` and no ``devices``, the fit runs
    ``n_shards`` (default 4) shards on ``device``.  Otherwise a
    single-process fit (``engine``, default the host ``grit``
    pipeline) is sharded host-side into ``n_shards`` slabs -- the same
    serving structure without several devices.  ``device=None`` is the
    CUDA device, as everywhere in the port.
    """
    from ..engine import cluster

    pts = np.asarray(points, np.float64)
    if devices is not None:
        res = cluster(pts, eps, min_pts, engine="distributed",
                      devices=devices, **opts)
        if n_shards is None:
            n_shards = len(devices)
    elif engine == "distributed":
        n_shards = 4 if n_shards is None else n_shards
        res = cluster(pts, eps, min_pts, engine="distributed",
                      n_shards=n_shards, device=device, **opts)
    else:
        res = cluster(pts, eps, min_pts, engine=engine or "grit",
                      device=device, **opts)
        if n_shards is None:
            n_shards = 4
    return ShardedGritIndex.from_global_fit(
        pts, eps, min_pts, labels=res.labels, core=res.core,
        n_shards=n_shards)
