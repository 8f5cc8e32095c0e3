"""Serving driver: continuous batching for clustering traffic.

The LM serving loop (``repro_torch.launch.serve``) left-pads ragged
prompts into batch slots, runs one batched program per step, and swaps
finished sequences out; this driver applies the same discipline to
point-query traffic against a fitted :class:`~repro_torch.index.GritIndex`:

* requests arrive as *ragged* [m_i, d] query batches -- or as mutation
  requests (:meth:`ClusterServer.submit_insert` /
  :meth:`ClusterServer.submit_delete`) -- and are admitted into
  ``slots`` request slots of ``query_cap`` queries each -- the step's
  admission budget (slot occupancy is reported per step);
* each step applies the admitted mutations in submission order, then
  concatenates the admitted query requests and runs one batched
  :meth:`GritIndex.predict` over them (predicts in a step observe the
  step's mutations), then retires every slot (requests finish in one
  step, so continuous batching reduces to refilling all slots from the
  queue).  The kernel-facing fixed shapes live inside the index
  (`PredictCaps` slot packing), not here.  Delete requests carry
  rejected-id telemetry through the step log and summary: unknown /
  already-deleted ids are normal serving traffic (TTL expiry racing
  explicit erasure, replays), rejected per id by the index, and must
  never poison the co-batched requests;
* caps grow, never shrink: an oversized request bumps the admission
  shape ``query_cap`` to the next power of two (the adaptive driver's
  quantization, shared via ``_pow2_at_least``), and the kernel path's
  :class:`PredictCaps` grow the same way inside the index.  Every
  growth event is recorded; the ``predict_caps`` events are the ones
  that change the kernel's slot shapes, while ``query_cap`` events
  record when traffic outgrew the admission tensor;
* per-request latency (submit -> labels) and per-step occupancy are
  recorded for the summary (p50/p95 latency, throughput);
* the server is index-agnostic: a
  :class:`~repro_torch.index.ShardedGritIndex` drops in as the backend
  unchanged -- its ``predict`` buckets the step's batch by owning slab
  internally (one batched per-shard call) and reports the routing
  counters (queries per slab, multi-routed cut-band queries) through
  the same per-step ``stats`` channel, so the step log shows slab
  occupancy next to slot occupancy.  Per-step slab load (owned routed
  queries + mutated rows per shard) is promoted to
  ``repro_torch.obs`` gauges -- ``serve.slab.load.<k>`` and the
  max/mean ``serve.slab.imbalance`` -- on both the per-server registry
  and the process default, so the rebalance trigger is visible in
  ``repro_torch.obs.view`` and trace exports;
* ``rebalance=`` attaches a
  :class:`~repro_torch.dist.rebalance.Rebalancer`: the slab-load
  gauges feed its EWMA and *between* steps it applies at most one
  bounded topology op (split the hottest slab / merge the coldest
  adjacent pair) to the sharded backend, recorded in
  ``topology_events``;
* ``replicas=R`` clones R read-only :class:`~repro_torch.index.ReplicaIndex`
  off the primary (mutation-log replay plane) and fans each step's
  predict batch across them round-robin -- mutations keep hitting the
  primary, replicas catch up from its log before answering, so the
  labels stay bit-identical to primary serving;
* ``device=`` is where the predicts run: it goes to every
  ``predict`` / ``predict_async`` / ``ensure_device_state`` call.
  ``None`` is the CUDA device (``RuntimeError`` when there is none);
  ``"cpu"`` runs the kernels' plain versions.

``python -m repro_torch.serve.driver --smoke [--device cpu]`` runs a
miniature server on a catalogue scenario: fit, then serve a stream of
ragged query batches; ``--sharded N`` serves from an N-slab
``ShardedGritIndex`` instead of the single-host index (the
distributed-serving backend); ``--rebalance`` / ``--replicas R`` attach
the topology and replica planes above, ``--device-state`` the resident
serving state.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from .. import obs
from ..engine.adaptive import _pow2_at_least, resolve_device
from ..obs.metrics import MetricsRegistry


@dataclasses.dataclass
class ClusterRequest:
    """One in-flight request: a ragged query batch (``kind="predict"``),
    a micro-batch insert (``kind="insert"``) or a delete-by-arrival-ids
    (``kind="delete"``).  Mutations carry their stats dict back on
    ``result``; predicts carry ``labels``."""

    rid: int
    points: np.ndarray                    # [m, d] ragged (empty: delete)
    t_submit: float
    kind: str = "predict"
    ids: Optional[np.ndarray] = None      # delete requests: arrival ids
    labels: Optional[np.ndarray] = None   # [m] int64 once served
    result: Optional[Dict[str, Any]] = None   # mutation stats once applied
    t_admit: float = 0.0                  # popped from the queue
    t_done: float = 0.0

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3


class ClusterServer:
    """Continuous-batching predict server over a fitted index."""

    def __init__(self, index, *, slots: int = 4, query_cap: int = 64,
                 mode: str = "auto", device_state: bool = False,
                 rebalance=None, replicas: int = 0, device=None):
        self.index = index
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.query_cap = _pow2_at_least(query_cap, lo=8)
        self.mode = mode
        self.pending: Deque[ClusterRequest] = deque()
        self.done: List[ClusterRequest] = []
        self.growth_events: List[Dict[str, Any]] = []
        self.step_log: List[Dict[str, Any]] = []
        self.rejected_ids: List[np.ndarray] = []   # delete telemetry
        # topology plane: load-triggered split/merge between steps
        self.rebalancer = None
        self.topology_events: List[Dict[str, Any]] = []
        if rebalance is not None and rebalance is not False:
            from ..dist.rebalance import RebalancePolicy, Rebalancer
            if isinstance(rebalance, Rebalancer):
                self.rebalancer = rebalance
            elif isinstance(rebalance, RebalancePolicy):
                self.rebalancer = Rebalancer(rebalance)
            else:
                self.rebalancer = Rebalancer()
            if not hasattr(index, "split_shard"):
                raise ValueError(
                    "rebalance= needs a backend with topology ops; "
                    f"{type(index).__name__} has no split_shard()")
        # replica plane: read-only clones fed by the primary's log;
        # each step's predict batch goes to one replica round-robin
        self.replicas: List[Any] = []
        self._rr = 0
        if replicas:
            from ..index.replica import make_replicas
            self.replicas = make_replicas(index, int(replicas))
        # per-server books (a process may run many servers; the shared
        # default registry keeps only cross-cutting counters) -- the
        # summary() aggregates are a view over these instruments
        self.metrics = MetricsRegistry()
        self._next_rid = 0
        # double-buffered admission: the batch packed while the previous
        # step's kernels were executing (device path), served next step
        self._staged: Optional[List[ClusterRequest]] = None
        if device_state:
            ensure = getattr(index, "ensure_device_state", None)
            if ensure is None:
                raise ValueError(
                    "device_state=True needs a backend with device-"
                    f"resident serving state; {type(index).__name__} "
                    "has no ensure_device_state()")
            ensure(self.device)

    # ------------------------------------------------------------------

    def submit(self, points) -> int:
        """Enqueue one ragged query batch; returns its request id.

        Validation happens *here*, at admission: a malformed request is
        rejected before it can join a batch, so it can never poison the
        co-batched requests of a serving step.
        """
        pts = np.asarray(points, np.float64)
        if pts.ndim != 2 or pts.shape[1] != self.index.d:
            raise ValueError(
                f"request must be [m, {self.index.d}], got {pts.shape}")
        if not np.isfinite(pts).all():
            raise ValueError("request contains non-finite coordinates")
        req = ClusterRequest(rid=self._next_rid, points=pts,
                             t_submit=time.perf_counter())
        self._next_rid += 1
        self.pending.append(req)
        return req.rid

    def submit_insert(self, points) -> int:
        """Enqueue a micro-batch insert; validated at admission like
        predicts, co-batched into a serving step with them."""
        pts = np.asarray(points, np.float64)
        if pts.ndim != 2 or pts.shape[1] != self.index.d:
            raise ValueError(
                f"request must be [m, {self.index.d}], got {pts.shape}")
        if not np.isfinite(pts).all():
            raise ValueError("request contains non-finite coordinates")
        req = ClusterRequest(rid=self._next_rid, points=pts,
                             kind="insert", t_submit=time.perf_counter())
        self._next_rid += 1
        self.pending.append(req)
        return req.rid

    def submit_delete(self, arrival_ids) -> int:
        """Enqueue a delete-by-arrival-ids request.

        Unknown / already-deleted ids are not an admission error -- the
        index rejects them individually and the step log carries the
        rejected-id telemetry (TTL races and replays are normal
        traffic, and one bad id must not poison a co-batched step).
        """
        ids = np.asarray(arrival_ids, np.int64).ravel()
        req = ClusterRequest(rid=self._next_rid,
                             points=np.zeros((0, self.index.d)),
                             kind="delete", ids=ids,
                             t_submit=time.perf_counter())
        self._next_rid += 1
        self.pending.append(req)
        return req.rid

    def _admit(self) -> List[ClusterRequest]:
        """Fill up to ``slots`` slots from the queue (admission-time
        ``query_cap`` growth included) -- the host-packing half of a
        step, so it can run while the previous step's kernels execute."""
        active: List[ClusterRequest] = []
        now = time.perf_counter()
        while self.pending and len(active) < self.slots:
            req = self.pending.popleft()
            req.t_admit = now
            active.append(req)
        need = max((len(r.points) for r in active
                    if r.kind == "predict"), default=0)
        if need > self.query_cap:
            grown = _pow2_at_least(need, lo=8)
            self.growth_events.append(
                {"step": len(self.step_log), "cap": "query_cap",
                 "was": self.query_cap, "now": grown})
            self.query_cap = grown
        return active

    def step(self) -> List[ClusterRequest]:
        """Serve one batch: fill up to ``slots`` slots, apply the
        admitted mutations (in submission order), then one predict call
        over the co-batched query requests -- predicts in a step
        observe that step's mutations.

        The admission is double-buffered: the predict is *dispatched*
        (``predict_async``), the *next* step's batch is admitted while
        the kernels run, and only then does the step block on the
        labels -- on the device path the host packing of step k+1
        overlaps the jitted program of step k.  The step log splits
        ``kernel_s`` (device kernel + resolve time) from ``pack_s``
        (host slot packing) next to the total ``seconds``.

        Returns the requests finished this step (empty when idle).
        """
        active = self._staged if self._staged is not None \
            else self._admit()
        self._staged = None
        if not active:
            return []
        predicts = [r for r in active if r.kind == "predict"]

        reg = self.metrics
        t0 = time.perf_counter()
        with obs.span("serve.step", requests=len(active)):
            inserted = deleted = rejected = 0
            kernel_s = pack_s = 0.0
            with obs.span("serve.step.mutate"):
                for r in active:
                    if r.kind == "insert":
                        r.result = self.index.insert(r.points)
                        inserted += r.result["inserted"]
                    elif r.kind == "delete":
                        r.result = self.index.delete(r.ids)
                        deleted += r.result["deleted"]
                        if r.result["rejected"]:
                            rejected += r.result["rejected"]
                            self.rejected_ids.append(
                                r.result["rejected_ids"])
                    if r.result is not None:
                        kernel_s += r.result.get("t_kernel", 0.0)
                        pack_s += r.result.get("t_pack", 0.0)
            pstats: Dict[str, Any] = {}
            flat = (np.concatenate([r.points for r in predicts])
                    if predicts else np.zeros((0, self.index.d)))
            # read fan-out: mutations hit the primary above; the step's
            # predict batch goes to one replica round-robin (it catches
            # up from the log first, so answers are bit-identical)
            reader = self.index
            if self.replicas and len(flat):
                reader = self.replicas[self._rr % len(self.replicas)]
                self._rr += 1
            dispatch = getattr(reader, "predict_async", None)
            # queue wait: admission (queue pop) -> this batch's dispatch
            t_disp = time.perf_counter()
            qw_ms = [(t_disp - r.t_admit) * 1e3 for r in active]
            for w in qw_ms:
                reg.histogram("serve.queue_wait_ms").observe(w)
            with obs.span("serve.step.dispatch", queries=len(flat)):
                if len(flat) == 0:
                    resolve = lambda: np.empty(0, np.int64)
                elif dispatch is not None:
                    resolve = dispatch(flat, mode=self.mode, stats=pstats,
                                       device=self.device)
                else:
                    out = reader.predict(flat, mode=self.mode,
                                         stats=pstats, device=self.device)
                    resolve = lambda: out
            # admit the next step's batch while the dispatched work runs
            with obs.span("serve.step.admit_next"):
                staged = self._admit()
                self._staged = staged if staged else None
            with obs.span("serve.step.resolve"):
                flat_labels = resolve()
            kernel_s += pstats.get("t_kernel", 0.0)
            pack_s += pstats.get("t_pack", 0.0)
            # slab-load gauges: owned routed queries + mutated rows per
            # shard -- the rebalance trigger, exported on both the
            # per-server registry and the process default registry so
            # it shows in repro_torch.obs.view and trace exports
            num_shards = int(getattr(self.index, "num_shards", 0))
            if num_shards:
                slab_load = np.zeros(num_shards, np.float64)
                owned = pstats.get("owned_per_shard")
                if owned is not None:
                    slab_load[:len(owned)] += owned
                for r in active:
                    if r.result is not None:
                        for s in r.result.get("per_shard", ()):
                            if s["shard"] < num_shards:
                                slab_load[s["shard"]] += \
                                    s["own"] + s["ghost"]
                mean = float(slab_load.mean())
                imb = float(slab_load.max()) / mean if mean > 0 else 1.0
                for k in range(num_shards):
                    v = float(slab_load[k])
                    reg.gauge(f"serve.slab.load.{k}").set(v)
                    obs.gauge(f"serve.slab.load.{k}").set(v)
                reg.gauge("serve.slab.imbalance").set(imb)
                obs.gauge("serve.slab.imbalance").set(imb)
                if self.rebalancer is not None:
                    self.rebalancer.observe(slab_load)
            t_step = time.perf_counter() - t0
            if pstats.get("caps_grew"):
                self.growth_events.append(
                    {"step": len(self.step_log), "cap": "predict_caps",
                     "now": pstats.get("caps")})

            off = 0
            now = time.perf_counter()
            for r in active:
                if r.kind == "predict":
                    m = len(r.points)
                    r.labels = flat_labels[off:off + m]
                    off += m
                r.t_done = now
                self.done.append(r)
                reg.histogram("serve.latency_ms").observe(r.latency_ms)
            slot_fill = len(flat) / (self.slots * self.query_cap)
            reg.counter("serve.steps").inc()
            reg.counter("serve.requests").inc(len(active))
            reg.counter("serve.queries").inc(len(flat))
            reg.counter("serve.inserted").inc(inserted)
            reg.counter("serve.deleted").inc(deleted)
            reg.counter("serve.rejected").inc(rejected)
            reg.histogram("serve.slot_fill").observe(slot_fill)
            reg.histogram("serve.step_seconds").observe(t_step)
            reg.histogram("serve.kernel_seconds").observe(kernel_s)
            reg.histogram("serve.pack_seconds").observe(pack_s)
            self.step_log.append(
                {"requests": len(active), "queries": len(flat),
                 "slot_fill": slot_fill,
                 "inserted": inserted, "deleted": deleted,
                 "rejected": rejected,
                 "queue_wait_ms": float(np.mean(qw_ms)),
                 "seconds": t_step, "kernel_s": kernel_s,
                 "pack_s": pack_s, "predict": pstats})
        # topology op *between* steps: bounded by the policy's period,
        # so reconcile cost amortizes against every subsequent step
        if self.rebalancer is not None:
            op_st = self.rebalancer.maybe_rebalance(self.index)
            if op_st is not None:
                self.topology_events.append(
                    {"step": len(self.step_log), **op_st})
                reg.counter("serve.topology_ops").inc()
        return active

    def run(self) -> List[ClusterRequest]:
        """Drain the queue (staged batch included); returns every
        request served."""
        out: List[ClusterRequest] = []
        while self.pending or self._staged is not None:
            out.extend(self.step())
        return out

    # ------------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Aggregate serving stats: a thin view over the per-server
        metrics registry (``self.metrics``) -- every number here is
        read back from the instruments ``step()`` feeds, so the same
        figures flow to trace exports (``repro_torch.obs``) unchanged.  The
        registry's exact-percentile histograms reproduce the
        ``np.percentile`` values this summary historically computed
        from the request list."""
        reg = self.metrics
        lat = reg.histogram("serve.latency_ms")
        qw = reg.histogram("serve.queue_wait_ms")
        served_s = reg.histogram("serve.step_seconds").total
        queries = reg.counter("serve.queries").value
        rejected = (np.concatenate(self.rejected_ids)
                    if self.rejected_ids else np.empty(0, np.int64))
        return {
            "requests": len(self.done),
            "queries": queries,
            "inserted": reg.counter("serve.inserted").value,
            "deleted": reg.counter("serve.deleted").value,
            "rejected": int(len(rejected)),
            "rejected_ids": rejected,
            "steps": len(self.step_log),
            "latency_ms_p50": lat.percentile(50),
            "latency_ms_p95": lat.percentile(95),
            "latency_ms_p99": lat.percentile(99),
            "latency_ms_mean": lat.mean,
            "queue_wait_ms_p50": qw.percentile(50),
            "queue_wait_ms_p95": qw.percentile(95),
            "queue_wait_ms_mean": qw.mean,
            "queries_per_s": queries / served_s if served_s else 0.0,
            "mean_slot_fill": reg.histogram("serve.slot_fill").mean,
            "query_cap": self.query_cap,
            "growth_events": list(self.growth_events),
            "topology_events": list(self.topology_events),
            "replicas": len(self.replicas),
        }


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="blobs-2d")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny request stream (CI-scale)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--num-requests", type=int, default=24)
    ap.add_argument("--max-queries", type=int, default=96)
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "host", "kernel", "device"))
    ap.add_argument("--device", default=None,
                    help="where the fit and the predicts run (default: "
                         "the CUDA device; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--device-state", action="store_true",
                    help="attach device-resident serving state to the "
                         "index (guard-band hot path; outputs stay "
                         "bit-identical to host serving)")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="serve from an N-slab ShardedGritIndex "
                         "(slab-routed predict) instead of the "
                         "single-host index")
    ap.add_argument("--rebalance", action="store_true",
                    help="attach a load-triggered Rebalancer to the "
                         "sharded backend (split hottest / merge "
                         "coldest between steps; needs --sharded)")
    ap.add_argument("--rebalance-period", type=int, default=8,
                    help="min steps between topology ops")
    ap.add_argument("--replicas", type=int, default=0, metavar="R",
                    help="fan predict traffic across R read-only "
                         "replicas fed by the primary's mutation log")
    ap.add_argument("--mutate", action="store_true",
                    help="mix insert and delete requests into the "
                         "stream (~70/20/10 predict/insert/delete, "
                         "incl. one bogus delete id for the rejected "
                         "telemetry)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..data.scenarios import get_scenario
    from ..engine import cluster

    sc = get_scenario(args.scenario)
    pts = sc.points(seed=args.seed)
    print(f"fitting {args.scenario} (n={len(pts)}, eps={sc.eps}, "
          f"min_pts={sc.min_pts}) with engine={args.engine}...")
    t0 = time.perf_counter()
    if args.sharded:
        from ..index import fit_sharded
        index = fit_sharded(pts, sc.eps, sc.min_pts,
                            n_shards=args.sharded, engine=args.engine,
                            device=args.device)
        print(f"  fit {time.perf_counter() - t0:.2f}s: "
              f"{index.num_shards} slab shards "
              f"(cuts at {np.round(index.cuts, 1).tolist()}), "
              f"{index.num_grids} grids total")
    else:
        res = cluster(pts, sc.eps, sc.min_pts, engine=args.engine,
                      device=args.device, return_index=True)
        index = res.index
        print(f"  fit {time.perf_counter() - t0:.2f}s: "
              f"{res.n_clusters} clusters, {index.num_grids} grids")

    rng = np.random.default_rng(args.seed)
    n_req = 6 if args.smoke else args.num_requests
    rebalance = None
    if args.rebalance:
        from ..dist.rebalance import RebalancePolicy
        rebalance = RebalancePolicy(period=args.rebalance_period)
    srv = ClusterServer(index, slots=args.slots, mode=args.mode,
                        device_state=args.device_state, rebalance=rebalance,
                        replicas=args.replicas, device=args.device)
    deletable = list(range(len(pts)))
    for i in range(n_req):
        kind = (rng.choice(["predict", "insert", "delete"],
                           p=[0.7, 0.2, 0.1]) if args.mutate
                else "predict")
        m = int(rng.integers(4, args.max_queries + 1))
        near = pts[rng.integers(0, len(pts), m)] + rng.normal(
            scale=sc.eps * 0.25, size=(m, sc.d))
        if kind == "insert":
            srv.submit_insert(near[:max(m // 4, 1)])
        elif kind == "delete" and deletable:
            k = min(len(deletable), int(rng.integers(1, 9)))
            pick = rng.choice(len(deletable), k, replace=False)
            ids = [deletable[j] for j in pick]
            for j in sorted(pick)[::-1]:
                deletable.pop(j)
            # one bogus id exercises the rejected-id telemetry
            srv.submit_delete(np.asarray(ids + [10 ** 9]))
        else:
            srv.submit(near)
    srv.run()
    s = srv.summary()
    print(f"served {s['requests']} requests / {s['queries']} queries in "
          f"{s['steps']} steps ({s['queries_per_s']:.0f} q/s)")
    if args.mutate:
        print(f"  mutations: {s['inserted']} inserted, "
              f"{s['deleted']} deleted, {s['rejected']} delete ids "
              f"rejected {s['rejected_ids'][:4].tolist()}...")
    print(f"  latency p50 {s['latency_ms_p50']:.2f}ms  "
          f"p95 {s['latency_ms_p95']:.2f}ms  "
          f"p99 {s['latency_ms_p99']:.2f}ms  "
          f"queue wait p50 {s['queue_wait_ms_p50']:.2f}ms  "
          f"slot fill {s['mean_slot_fill']:.2f}  "
          f"cap growth events: {len(s['growth_events'])}")
    noise = sum(int((r.labels < 0).sum()) for r in srv.done
                if r.labels is not None)
    print(f"  noise rate {noise / max(s['queries'], 1):.2f}")
    if args.sharded:
        routed = sum(st["predict"].get("multi_routed", 0)
                     for st in srv.step_log)
        imb = srv.metrics.gauge("serve.slab.imbalance").value
        print(f"  slab routing: {index.num_shards} shards, "
              f"imbalance (max/mean) {imb:.2f}, "
              f"{routed} cut-band queries consulted both neighbors")
    if srv.rebalancer is not None:
        ops = [(e["op"], e["shard"]) for e in srv.topology_events]
        print(f"  topology ops: {ops} -> {index.num_shards} shards, "
              f"cut history {len(index.cut_history)} entries")
    if srv.replicas:
        print(f"  replicas: {len(srv.replicas)} read-only, lag "
              f"{[r.lag for r in srv.replicas]} ops behind primary")


if __name__ == "__main__":
    main()
