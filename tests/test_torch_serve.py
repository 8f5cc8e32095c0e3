"""The port's serving driver (``repro_torch.serve``) and read replicas
(``repro_torch.index.replica``): twins of ``tests/test_serve.py``'s
single-index cases and of ``tests/test_topology.py::TestReplica``, and
a scripted trace served by the reference's ``ClusterServer`` and the
port's side by side.

The continuous-batching driver must return exactly what a direct
``GritIndex.predict`` returns for every ragged request, record
per-request latency, and grow its caps (never truncate) when traffic
exceeds them.  A caught-up replica answers bit-identically to its
primary.  On the same stream of predicts, inserts and deletes, the
port's server gives the reference's labels request for request, and
the same step log and growth events, in host, kernel (the plain
``row_min_batch`` on the CPU) and device (a resident state on the CPU)
modes.  A sharded index drops into ``ClusterServer`` as a backend
(twins of ``tests/test_serve.py``'s sharded cases and of
``tests/test_topology.py::TestServeIntegration``): its slab-load
gauges, its rebalance plane and its replicated reads give what the
reference's server gives on the same scripted trace.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.scenarios import get_serving_scenario
from repro_torch.engine import cluster
from repro_torch.index import (GritIndex, ReplicaIndex, fit_index,
                               fit_sharded, make_replicas)
from repro_torch.serve import ClusterServer
from repro_torch.serve import driver as serve_driver


@pytest.fixture(scope="module")
def served_index():
    ss = get_serving_scenario("query-heavy-3d")
    pts = ss.fit_points()
    res = cluster(pts, ss.base.eps, ss.base.min_pts, engine="grit",
                  device="cpu", return_index=True)
    return ss, res.index


def _ragged_requests(ss, seed, sizes):
    q = ss.query_batch(seed=seed, n=int(sum(sizes)))
    out, off = [], 0
    for m in sizes:
        out.append(q[off:off + m])
        off += m
    return out


# --------------------------------------------------------------------------
# twins of tests/test_serve.py (single index)
# --------------------------------------------------------------------------

def test_server_labels_match_direct_predict(served_index):
    ss, idx = served_index
    reqs = _ragged_requests(ss, 0, [7, 31, 2, 18, 25, 13])
    srv = ClusterServer(idx, slots=4, mode="host", device="cpu")
    rids = [srv.submit(r) for r in reqs]
    done = srv.run()
    assert sorted(r.rid for r in done) == rids
    for r, pts in zip(sorted(done, key=lambda r: r.rid), reqs):
        np.testing.assert_array_equal(r.labels,
                                      idx.predict(pts, mode="host"))
        assert r.latency_ms >= 0.0


def test_server_batches_into_slots(served_index):
    ss, idx = served_index
    srv = ClusterServer(idx, slots=3, mode="host", device="cpu")
    for r in _ragged_requests(ss, 1, [5] * 7):
        srv.submit(r)
    srv.run()
    # 7 requests over 3 slots -> ceil(7/3) = 3 steps
    assert len(srv.step_log) == 3
    assert [s["requests"] for s in srv.step_log] == [3, 3, 1]
    assert all(s["queries"] == s["requests"] * 5 for s in srv.step_log)


def test_server_grows_query_cap_on_oversized_request(served_index):
    ss, idx = served_index
    srv = ClusterServer(idx, slots=2, query_cap=8, mode="host",
                        device="cpu")
    big = _ragged_requests(ss, 2, [50])[0]
    srv.submit(big)
    (done,) = srv.step()
    assert len(done.labels) == 50
    assert srv.query_cap >= 50
    growth = [e for e in srv.growth_events if e["cap"] == "query_cap"]
    assert growth and growth[0]["was"] == 8
    # caps never shrink: a later small request keeps the grown cap
    srv.submit(_ragged_requests(ss, 3, [4])[0])
    srv.step()
    assert srv.query_cap == growth[0]["now"]


def test_server_kernel_mode_records_predict_caps(served_index):
    ss, idx = served_index
    srv = ClusterServer(idx, slots=2, mode="kernel", device="cpu")
    for r in _ragged_requests(ss, 4, [12, 20]):
        srv.submit(r)
    srv.run()
    assert all(s["predict"]["mode"] == "kernel" for s in srv.step_log)
    assert all(s["predict"]["caps"]["group_cap"] >= 8
               for s in srv.step_log)


def test_server_summary_stats(served_index):
    ss, idx = served_index
    srv = ClusterServer(idx, slots=4, mode="host", device="cpu")
    for r in _ragged_requests(ss, 5, [10, 10, 10, 10]):
        srv.submit(r)
    srv.run()
    s = srv.summary()
    assert s["requests"] == 4 and s["queries"] == 40
    assert s["steps"] == 1
    assert s["latency_ms_p95"] >= s["latency_ms_p50"] > 0
    assert s["queries_per_s"] > 0
    assert 0 < s["mean_slot_fill"] <= 1


def test_server_rejects_bad_request_at_admission(served_index):
    """Malformed requests must be rejected in submit(), before they can
    join a batch -- a NaN request must never poison co-batched ones."""
    ss, idx = served_index
    srv = ClusterServer(idx, mode="host", device="cpu")
    with pytest.raises(ValueError, match="request must be"):
        srv.submit(np.zeros((4, idx.d + 1)))
    good = _ragged_requests(ss, 6, [9])[0]
    srv.submit(good)
    bad = np.zeros((4, idx.d))
    bad[2, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        srv.submit(bad)
    (done,) = srv.run()              # the good request still serves
    np.testing.assert_array_equal(done.labels,
                                  idx.predict(good, mode="host"))


def test_server_idle_step_is_noop(served_index):
    _, idx = served_index
    srv = ClusterServer(idx, device="cpu")
    assert srv.step() == []
    assert srv.step_log == []


# --------------------------------------------------------------------------
# the port's device rule
# --------------------------------------------------------------------------

def test_default_device_is_the_card_and_raises_without_one(served_index):
    _, idx = served_index
    if torch.cuda.is_available():
        assert ClusterServer(idx).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            ClusterServer(idx)


def test_smoke_cli_serves_with_replicas_and_mutations(capsys):
    serve_driver.main(["--smoke", "--device", "cpu", "--mutate",
                       "--replicas", "1", "--mode", "device",
                       "--device-state"])
    out = capsys.readouterr().out
    assert "served 6 requests" in out
    assert "replicas: 1 read-only, lag [0]" in out


# --------------------------------------------------------------------------
# twins of tests/test_topology.py::TestReplica (no sharded case)
# --------------------------------------------------------------------------

EPS, MIN_PTS = 0.6, 6


@pytest.fixture()
def blobs():
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal((0, 0), 1.0, (400, 2)),
        rng.normal((8, 1), 1.2, (400, 2)),
        rng.normal((4, -3), 0.8, (300, 2)),
    ])


def _fit(pts):
    return fit_index(pts, EPS, MIN_PTS, device="cpu")


class TestReplica:
    def test_requires_mutation_log(self, blobs):
        idx = _fit(blobs)
        with pytest.raises(ValueError, match="enable_mutation_log"):
            ReplicaIndex(idx)

    def test_replay_is_bit_identical(self, blobs):
        rng = np.random.default_rng(2)
        idx = _fit(blobs[:900])
        idx.enable_mutation_log()
        rep = ReplicaIndex(idx)
        idx.insert(blobs[900:1000])
        idx.insert(blobs[1000:])
        idx.delete(np.arange(30, dtype=np.int64))
        assert rep.lag == 3
        assert rep.catch_up() == 3
        assert rep.lag == 0
        assert np.array_equal(rep.labels_arrival(), idx.labels_arrival())
        assert np.array_equal(rep.core_arrival(), idx.core_arrival())
        q = rng.normal((4, -1), 3.0, (200, 2))
        assert np.array_equal(rep.predict(q, device="cpu"),
                              idx.predict(q, device="cpu"))
        for mode in ("kernel", "device"):
            assert np.array_equal(rep.predict(q, mode=mode, device="cpu"),
                                  idx.predict(q, mode="host"))

    def test_replica_owns_its_state(self, blobs):
        """A delete updates the primary's arrays in place; a replica
        cloned before it must not see it until it replays it (the
        reference's clone shares the snapshot's arrays, and its merge
        graph then falls behind the primary's)."""
        idx = _fit(blobs)
        idx.ensure_merge_graph()
        idx.enable_mutation_log()
        rep = ReplicaIndex(idx)
        assert not any(np.shares_memory(a, b) for a, b in zip(
            rep.index.snapshot().values(), idx.snapshot().values()))
        idx.delete(np.arange(600))
        assert rep.index.n_live == len(blobs)       # not replayed yet
        rep.catch_up()
        idx.insert(blobs[:300] + 0.05)
        rep.catch_up()
        assert np.array_equal(rep.index.merge_edges, idx.merge_edges)
        assert np.array_equal(rep.labels_arrival(), idx.labels_arrival())
        assert np.array_equal(rep.core_arrival(), idx.core_arrival())

    def test_read_only(self, blobs):
        idx = _fit(blobs)
        idx.enable_mutation_log()
        rep = ReplicaIndex(idx)
        with pytest.raises(TypeError, match="read-only"):
            rep.insert(blobs[:2])
        with pytest.raises(TypeError, match="read-only"):
            rep.delete(np.asarray([0]))

    def test_stale_cursor_rejected(self, blobs):
        idx = _fit(blobs)
        log = idx.enable_mutation_log()
        rep = ReplicaIndex(idx)
        idx.insert(blobs[:10] + 100.0)
        log.truncate(log.end)           # primary drops replayed history
        rep.cursor = 0
        with pytest.raises(ValueError, match="re-clone"):
            rep.catch_up()

    def test_log_truncate_keeps_live_suffix(self, blobs):
        idx = _fit(blobs)
        log = idx.enable_mutation_log()
        rep = ReplicaIndex(idx)
        idx.insert(blobs[:10] + 100.0)
        idx.insert(blobs[10:20] + 100.0)
        rep.catch_up()
        idx.insert(blobs[20:30] + 100.0)
        assert log.truncate(rep.cursor) == 2
        assert rep.catch_up() == 1      # suffix still replayable
        assert np.array_equal(rep.labels_arrival(), idx.labels_arrival())

    def test_replicated_reads_match_primary_serving(self, blobs):
        """Same request stream through a replicated server and a plain
        one: identical labels on every request."""
        def serve(**kw):
            srv = ClusterServer(_fit(blobs), slots=2, device="cpu", **kw)
            rng = np.random.default_rng(9)
            for i in range(12):
                if i % 4 == 3:
                    srv.submit_insert(rng.normal((8, 1), 1.2, (20, 2)))
                else:
                    srv.submit(rng.normal((4, -1), 3.0, (30, 2)))
            return srv, srv.run()

        srv_a, done_a = serve()
        srv_b, done_b = serve(replicas=2)
        assert len(srv_b.replicas) == 2
        assert srv_b._rr > 0            # reads actually fanned out
        for ra, rb in zip(done_a, done_b):
            assert ra.kind == rb.kind
            if ra.kind == "predict":
                assert np.array_equal(ra.labels, rb.labels)
        assert np.array_equal(srv_a.index.labels_arrival(),
                              srv_b.index.labels_arrival())
        for rep in srv_b.replicas:      # a replica lags until it reads
            rep.catch_up()
            assert rep.lag == 0
            assert np.array_equal(rep.labels_arrival(),
                                  srv_b.index.labels_arrival())
        assert make_replicas(srv_b.index, 0) == []


# --------------------------------------------------------------------------
# scripted trace: the reference's server and the port's, side by side
# --------------------------------------------------------------------------

LOG_KEYS = ("requests", "queries", "inserted", "deleted", "rejected")


def _script(ss, idx):
    """A fixed stream: ragged predicts (one oversized, to grow
    ``query_cap``), two inserts and two deletes (one with a bogus and a
    repeated id) at fixed positions."""
    rng = np.random.default_rng(11)
    live = idx.arrival_live()
    ins = ss.insert_batches(seed=2, steps=2)
    kill = rng.choice(live, 40, replace=False)
    sizes = [9, 70, 3, 25, 14, 1, 33, 6, 18, 11]
    q = ss.query_batch(seed=5, n=int(sum(sizes)))
    out, off = [], 0
    for i, m in enumerate(sizes):
        out.append(("predict", q[off:off + m]))
        off += m
        if i == 2:
            out.append(("insert", ins[0]))
        if i == 4:
            out.append(("delete", np.concatenate([kill[:25], [10 ** 9]])))
        if i == 6:
            out.append(("insert", ins[1]))
        if i == 7:
            out.append(("delete", np.concatenate([kill[20:], kill[:2]])))
    return out


def _serve_script(srv, script):
    for kind, payload in script:
        {"predict": srv.submit, "insert": srv.submit_insert,
         "delete": srv.submit_delete}[kind](payload)
    return sorted(srv.run(), key=lambda r: r.rid)


@pytest.mark.parametrize("mode", ["host", "kernel", "device"])
def test_scripted_trace_equals_the_reference_server(mode):
    from repro.engine import cluster as jcluster
    from repro.data.scenarios import get_serving_scenario as jget
    from repro.serve import ClusterServer as JServer

    jss = jget("query-heavy-3d")
    jidx = jcluster(jss.fit_points(), jss.base.eps, jss.base.min_pts,
                    engine="grit", return_index=True).index
    # the port's index is the reference's, restored from its snapshot
    pidx = GritIndex.restore(jidx.snapshot())
    ss = get_serving_scenario("query-heavy-3d")
    script = _script(ss, pidx)
    dev = mode == "device"
    jsrv = JServer(jidx, slots=3, query_cap=16, mode=mode,
                   device_state=dev)
    psrv = ClusterServer(pidx, slots=3, query_cap=16, mode=mode,
                         device_state=dev, device="cpu")
    jdone = _serve_script(jsrv, script)
    pdone = _serve_script(psrv, script)
    assert len(jdone) == len(pdone) == len(script)
    for a, b in zip(jdone, pdone):
        assert a.kind == b.kind
        if a.kind == "predict":
            np.testing.assert_array_equal(np.asarray(a.labels), b.labels)
    assert [{k: s[k] for k in LOG_KEYS} for s in jsrv.step_log] \
        == [{k: s[k] for k in LOG_KEYS} for s in psrv.step_log]
    assert jsrv.growth_events == psrv.growth_events
    assert {s["predict"]["mode"] for s in psrv.step_log if s["queries"]} \
        == {mode}
    assert any(e["cap"] == "query_cap" for e in psrv.growth_events)
    assert sum(s["rejected"] for s in psrv.step_log) == 8  # 1 + 5 + 2
    np.testing.assert_array_equal(jidx.labels_arrival(),
                                  pidx.labels_arrival())
    np.testing.assert_array_equal(jidx.core_arrival(), pidx.core_arrival())


# --------------------------------------------------------------------------
# sharded backend (twins of tests/test_serve.py's sharded cases)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_index():
    from repro_torch.data.scenarios import get_dist_serving_scenario

    ss = get_dist_serving_scenario("slab-serve-2d")
    pts = ss.fit_points()
    sidx = fit_sharded(pts, ss.base.eps, ss.base.min_pts, n_shards=4,
                       engine="grit", device="cpu")
    return ss, sidx


@pytest.mark.parametrize("mode", ["host", "kernel"])
def test_server_sharded_backend_matches_direct_predict(sharded_index, mode):
    """A ShardedGritIndex drops into ``ClusterServer`` unchanged:
    per-request labels equal a direct slab-routed predict, and the step
    log carries the slab-routing counters."""
    ss, sidx = sharded_index
    reqs = _ragged_requests(ss, 7, [11, 29, 4, 17])
    srv = ClusterServer(sidx, slots=3, mode=mode, device="cpu")
    rids = [srv.submit(r) for r in reqs]
    done = srv.run()
    assert sorted(r.rid for r in done) == rids
    for r, pts in zip(sorted(done, key=lambda r: r.rid), reqs):
        np.testing.assert_array_equal(
            r.labels, sidx.predict(pts, mode=mode, device="cpu"))
    for s in srv.step_log:
        assert s["predict"]["shards"] == sidx.num_shards
        assert s["predict"]["mode"] == mode
        assert sum(s["predict"]["owned_per_shard"]) == s["queries"]


def test_server_sharded_routes_cut_band_queries(sharded_index):
    ss, sidx = sharded_index
    srv = ClusterServer(sidx, slots=2, mode="host", device="cpu")
    srv.submit(ss.query_batch(seed=1))
    srv.run()
    assert sum(s["predict"]["multi_routed"] for s in srv.step_log) > 0


def test_sharded_backend_has_no_resident_state(sharded_index):
    """``device_state=True`` needs ``ensure_device_state()``, which a
    sharded index does not have (nor has the reference's)."""
    _, sidx = sharded_index
    with pytest.raises(ValueError, match="no ensure_device_state"):
        ClusterServer(sidx, device_state=True, device="cpu")


def test_rebalance_needs_topology_backend(blobs):
    with pytest.raises(ValueError, match="split_shard"):
        ClusterServer(_fit(blobs), rebalance=True, device="cpu")


@pytest.mark.parametrize("argv,lines", [
    (["--sharded", "4", "--rebalance"],
     ["4 slab shards", "slab routing: 4 shards", "topology ops: []"]),
    (["--sharded", "3", "--rebalance", "--rebalance-period", "1",
      "--mutate", "--replicas", "1", "--engine", "distributed"],
     ["3 slab shards", "slab routing: 3 shards", "topology ops: ",
      "mutations: ", "replicas: 1 read-only, lag [0]"]),
])
def test_smoke_cli_sharded_rebalance(capsys, argv, lines):
    serve_driver.main(["--smoke", "--device", "cpu"] + argv)
    out = capsys.readouterr().out
    assert "served 6 requests" in out
    for line in lines:
        assert line in out, (line, out)


# --------------------------------------------------------------------------
# slab gauges, the rebalance plane and replicated reads against the
# reference's server (twins of tests/test_topology.py::TestServeIntegration)
# --------------------------------------------------------------------------

def _topology_serve(pkg, pts, **kw):
    """The reference's TestServeIntegration stream through ``pkg``'s
    sharded index and server: 12 requests over 2 slots, every fourth an
    insert."""
    import importlib

    index = importlib.import_module(f"{pkg}.index")
    serve = importlib.import_module(f"{pkg}.serve")
    dkw = {"device": "cpu"} if pkg == "repro_torch" else {}
    if "rebalance" in kw:
        rb = importlib.import_module(f"{pkg}.dist.rebalance")
        kw["rebalance"] = rb.RebalancePolicy(**kw["rebalance"])
    sidx = index.fit_sharded(pts, EPS, MIN_PTS, n_shards=3, **dkw)
    srv = serve.ClusterServer(sidx, slots=2, **kw, **dkw)
    rng = np.random.default_rng(9)
    for i in range(12):
        if i % 4 == 3:
            srv.submit_insert(rng.normal((8, 1), 1.2, (20, 2)))
        else:
            srv.submit(rng.normal((4, -1), 3.0, (30, 2)))
    return srv, sorted(srv.run(), key=lambda r: r.rid)


def _slab_metrics(srv):
    snap = srv.metrics.snapshot()
    return {k: v for k, v in snap.items()
            if k.startswith("serve.slab") or k == "serve.topology_ops"}


@pytest.mark.parametrize("case", ["plain", "rebalance", "replicas",
                                  "rebalance+replicas"])
def test_sharded_trace_equals_the_reference_server(blobs, case):
    kw = {}
    if "rebalance" in case:
        kw["rebalance"] = dict(period=1, hot_factor=1.01, cold_factor=0.0)
    if "replicas" in case:
        kw["replicas"] = 2
    jsrv, jdone = _topology_serve("repro", blobs, **dict(kw))
    psrv, pdone = _topology_serve("repro_torch", blobs, **dict(kw))
    assert len(jdone) == len(pdone) == 12
    for a, b in zip(jdone, pdone):
        assert a.kind == b.kind
        if a.kind == "predict":
            np.testing.assert_array_equal(np.asarray(a.labels), b.labels)
    assert [{k: s[k] for k in LOG_KEYS} for s in jsrv.step_log] \
        == [{k: s[k] for k in LOG_KEYS} for s in psrv.step_log]
    assert [{k: s["predict"].get(k) for k in ("per_shard", "multi_routed",
                                              "owned_per_shard")}
            for s in jsrv.step_log] == \
        [{k: s["predict"].get(k) for k in ("per_shard", "multi_routed",
                                           "owned_per_shard")}
         for s in psrv.step_log]
    strip = lambda evs: [{k: v for k, v in e.items() if k != "t_total"}
                         for e in evs]
    assert strip(jsrv.topology_events) == strip(psrv.topology_events)
    assert _slab_metrics(jsrv) == _slab_metrics(psrv)
    names = str(list(_slab_metrics(psrv)))
    assert "serve.slab.imbalance" in names
    assert "serve.slab.load.0" in names
    np.testing.assert_array_equal(jsrv.index.labels_arrival(),
                                  psrv.index.labels_arrival())
    assert psrv.index.cut_history == jsrv.index.cut_history
    if "rebalance" in case:
        assert psrv.topology_events
        assert psrv.index.num_shards > 3
        assert all(e["op"] == "split" for e in psrv.topology_events)
        assert psrv.summary()["topology_events"] == psrv.topology_events
    else:
        assert psrv.topology_events == [] and psrv.index.num_shards == 3
    if "replicas" in case:
        assert len(psrv.replicas) == 2 and psrv._rr > 0
        for rep in psrv.replicas:
            rep.catch_up()
            np.testing.assert_array_equal(rep.labels_arrival(),
                                          psrv.index.labels_arrival())
            assert rep.index.cut_history == psrv.index.cut_history
