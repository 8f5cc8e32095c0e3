"""Port mutation plane vs the JAX package (twin of ``tests/test_delta.py``):
the same insert / delete / compact op streams, made from seeded numpy,
go through ``repro.index.GritIndex`` and ``repro_torch.index.GritIndex``
fitted from the same labels, and after every op both hold equal
``labels_arrival``, ``core_arrival``, ``merge_edges`` and row state, and
return equal mutation stats (all keys but the wall time ``t_total``).
Where the op stream is engineered (bridge cuts, demotions, deletes below
the shifted origin, emptied grids) the port is also held to the brute
oracle on the surviving set."""

import zlib

import numpy as np
import pytest

import repro.index.delta as jdelta
from repro.core.dbscan import grit_dbscan
from repro.index import GritIndex as JIndex
from repro_torch.core.validate import assert_labels_conformant, core_flags
from repro_torch.core.dbscan import brute_dbscan
from repro_torch.data.scenarios import (churn_scenarios, get_churn_scenario,
                                        get_serving_scenario,
                                        serving_scenarios)
from repro_torch.index import GritIndex, build_merge_graph
from repro_torch.index import delta as tdelta

CHURN = sorted(s.name for s in churn_scenarios())
SERVING = sorted(s.name for s in serving_scenarios())
WALL = {"t_total"}


def _seed(*key) -> int:
    return zlib.crc32("/".join(map(str, key)).encode())


class Twin:
    """One reference and one port index fitted from the same labels;
    every op goes to both and is checked at once."""

    def __init__(self, pts, eps, min_pts):
        res = grit_dbscan(pts, eps, min_pts)
        self.ref = JIndex.from_fit(pts, eps, min_pts, res.labels,
                                   core=res.core)
        self.port = GritIndex.from_fit(pts, eps, min_pts, res.labels,
                                       core=res.core)
        self.steps = 0

    def __call__(self, op, *arg):
        sr = getattr(self.ref, op)(*arg)
        sp = getattr(self.port, op)(*arg)
        self.steps += 1
        where = (op, self.steps)
        assert set(sr) == set(sp), where
        for k in set(sr) - WALL:
            np.testing.assert_array_equal(sp[k], sr[k], err_msg=f"{where} {k}")
        self.check(where)
        return sp

    def check(self, where=None):
        p, r = self.port, self.ref
        np.testing.assert_array_equal(p.labels_arrival(), r.labels_arrival(),
                                      err_msg=str(where))
        np.testing.assert_array_equal(p.core_arrival(), r.core_arrival(),
                                      err_msg=str(where))
        for f in ("points", "arrival", "alive", "ids", "starts", "counts",
                  "live_counts", "id_shift", "labels"):
            np.testing.assert_array_equal(getattr(p, f), getattr(r, f),
                                          err_msg=f"{where} {f}")
        assert (p.next_label, p.next_arrival, p.ops_applied) == \
            (r.next_label, r.next_arrival, r.ops_applied), where
        if p.merge_edges is None or r.merge_edges is None:
            assert p.merge_edges is None and r.merge_edges is None, where
        else:
            np.testing.assert_array_equal(p.merge_edges, r.merge_edges,
                                          err_msg=str(where))


def _conformant(idx, surv, eps, min_pts):
    ref = brute_dbscan(surv, eps, min_pts)
    assert_labels_conformant(surv, eps, min_pts, ref, idx.labels_arrival())
    np.testing.assert_array_equal(idx.core_arrival(),
                                  core_flags(surv, eps, min_pts))


# --------------------------------------------------------------------------
# catalogue streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", CHURN)
def test_churn_stream_equal(name):
    sc = get_churn_scenario(name)
    tw = Twin(sc.fit_points(), sc.base.eps, sc.base.min_pts)
    for op, arg in sc.ops():
        tw(op, arg)
    assert tw.port.ops_applied == len(sc.ops())


@pytest.mark.parametrize("name", SERVING)
def test_serving_insert_stream_equal(name):
    ss = get_serving_scenario(name)
    tw = Twin(ss.fit_points(), ss.base.eps, ss.base.min_pts)
    for b in ss.insert_batches():
        st = tw("insert", b)
        assert st["inserted"] == len(b)
    q = ss.query_batch()
    lp, dp = tw.port.predict(q, mode="host", return_d2=True)
    lr, dr = tw.ref.predict(q, mode="host", return_d2=True)
    np.testing.assert_array_equal(lp, lr)
    np.testing.assert_array_equal(dp, dr)


@pytest.mark.parametrize("seed", range(3))
def test_random_interleave_equal(seed):
    """Bridges, jittered copies and fresh regions, then a random fifth
    of the live set deleted, and a compaction at the end."""
    rng = np.random.default_rng(_seed("interleave", seed))
    eps, min_pts = 6.0, 4
    centers = rng.uniform(20, 80, size=(3, 2))
    base = np.concatenate([
        centers[rng.integers(0, 3, 90)] + rng.normal(scale=4.0, size=(90, 2)),
        rng.uniform(0, 100, size=(20, 2))])
    tw = Twin(base, eps, min_pts)
    live = {i: p for i, p in enumerate(base)}
    nid = len(base)
    for _ in range(3):
        a, b = base[rng.integers(0, len(base), (2, 12))]
        batch = np.concatenate([
            a + rng.uniform(0, 1, size=(12, 1)) * (b - a),
            base[rng.integers(0, len(base), 8)]
            + rng.normal(scale=0.5 * eps, size=(8, 2)),
            rng.uniform(-15, 115, size=(8, 2))])
        tw("insert", batch)
        for p in batch:
            live[nid] = p
            nid += 1
        kill = rng.choice(sorted(live), size=len(live) // 5, replace=False)
        tw("delete", np.concatenate([kill, [10 ** 9]]))   # one bogus id
        for k in kill:
            live.pop(int(k))
        _conformant(tw.port, np.array([live[i] for i in sorted(live)]),
                    eps, min_pts)
    tw("compact")
    assert tw.port.n == tw.port.n_live


# --------------------------------------------------------------------------
# engineered streams
# --------------------------------------------------------------------------

def test_bridge_cut_splits_cluster_in_two():
    rng = np.random.default_rng(3)
    eps, min_pts = 5.0, 4
    left = np.array([20.0, 50.0]) + rng.normal(scale=1.5, size=(24, 2))
    right = np.array([80.0, 50.0]) + rng.normal(scale=1.5, size=(24, 2))
    base = np.concatenate([left, right])
    tw = Twin(base, eps, min_pts)
    t = np.linspace(0, 1, 60)[:, None]
    tw("insert", left[0] + t * (right[0] - left[0])
       + rng.normal(scale=0.2, size=(60, 2)))
    la = tw.port.labels_arrival()
    assert len(set(la[la >= 0].tolist())) == 1
    st = tw("delete", np.arange(len(base), len(base) + 60))
    assert st["deleted"] == 60
    la = tw.port.labels_arrival()
    assert len(set(la[la >= 0].tolist())) == 2
    _conformant(tw.port, base, eps, min_pts)


def test_delete_demotes_core_and_below_origin_after_id_shift():
    rng = np.random.default_rng(5)
    eps, min_pts = 4.0, 6
    blob = np.full(2, 50.0) + rng.normal(scale=1.0, size=(40, 2))
    tw = Twin(blob, eps, min_pts)
    st = tw("delete", np.arange(min_pts - 2, 40))
    assert st["demoted"] > 0
    _conformant(tw.port, blob[:min_pts - 2], eps, min_pts)
    below = blob.min(axis=0) - 9 * eps + rng.uniform(0, 2 * eps,
                                                     size=(4 * min_pts, 2))
    st = tw("insert", below)
    assert st["id_shifted"]
    ids = np.arange(40, 40 + len(below))
    tw("delete", ids[::2])
    _conformant(tw.port, np.concatenate([blob[:min_pts - 2], below[1::2]]),
                eps, min_pts)
    np.testing.assert_array_equal(
        tw.port.query_ids(tw.port.points[tw.port.alive]),
        np.repeat(tw.port.ids, tw.port.counts, axis=0)[tw.port.alive])


def test_delete_a_whole_grid_then_everything_then_reuse():
    rng = np.random.default_rng(9)
    eps, min_pts = 6.0, 4
    base = rng.uniform(0, 100, size=(150, 2))
    tw = Twin(base, eps, min_pts)
    g = int(np.argmax(tw.port.live_counts))
    rows = np.arange(tw.port.starts[g],
                     tw.port.starts[g] + tw.port.counts[g])
    ids = tw.port.arrival[rows]
    grids = tw.port.num_grids
    tw("delete", ids)
    tw("compact")
    assert tw.port.num_grids < grids
    _conformant(tw.port, np.delete(base, ids, axis=0), eps, min_pts)
    st = tw("delete", [3, 3, 10 ** 7, -5])
    assert st["rejected"] >= 2
    tw("delete", tw.port.arrival_live())
    assert tw.port.n_live == 0
    assert (tw.port.predict(base[:7], device="cpu") == -1).all()
    blob = np.full(2, 30.0) + rng.normal(scale=0.8, size=(4 * min_pts, 2))
    tw("insert", blob)
    _conformant(tw.port, blob, eps, min_pts)
    st = tw("delete", np.zeros(0, np.int64))
    assert st["deleted"] == 0 and "affected_grids" in st


def test_compaction_threshold_triggers_equally():
    rng = np.random.default_rng(19)
    base = rng.uniform(0, 80, size=(200, 2))
    tw = Twin(base, 5.0, 4)
    tw.port.compact_threshold = tw.ref.compact_threshold = 0.1
    st = tw("delete", np.arange(0, 60))
    assert st["compacted"] and tw.port.n == tw.port.n_live == 140


# --------------------------------------------------------------------------
# merge graph, components, replication log
# --------------------------------------------------------------------------

def test_merge_graph_equal_and_incremental_equals_from_scratch():
    sc = get_churn_scenario("churn-split-2d")
    tw = Twin(sc.fit_points(), sc.base.eps, sc.base.min_pts)
    np.testing.assert_array_equal(build_merge_graph(tw.port),
                                  jdelta.build_merge_graph(tw.ref))
    for op, arg in sc.ops():
        tw(op, arg)
        fresh = GritIndex.restore(tw.port.snapshot())
        fresh.merge_edges = None
        np.testing.assert_array_equal(tw.port.merge_edges,
                                      build_merge_graph(fresh))


def test_grid_components_equal():
    rng = np.random.default_rng(17)
    for G in (1, 40, 300):
        edges = np.unique(np.sort(rng.integers(0, G, size=(2 * G, 2)),
                                  axis=1), axis=0)
        edges = edges[edges[:, 0] != edges[:, 1]]
        np.testing.assert_array_equal(tdelta.grid_components(G, edges),
                                      jdelta.grid_components(G, edges))


def test_relabel_local_components_equal():
    ss = get_serving_scenario("drift-2d")
    tw = Twin(ss.fit_points(), ss.base.eps, ss.base.min_pts)
    tw("insert", ss.insert_batches()[0])
    sp = tdelta.relabel_local_components(tw.port)
    sr = jdelta.relabel_local_components(tw.ref)
    assert sp.keys() == sr.keys()
    for k in set(sp) - WALL:
        np.testing.assert_array_equal(np.asarray(sp[k]), np.asarray(sr[k]))
    tw.check("relabel")


def test_mutation_log_records_the_same_ops():
    sc = get_churn_scenario("ttl-drift-3d")
    tw = Twin(sc.fit_points(), sc.base.eps, sc.base.min_pts)
    lp, lr = tw.port.enable_mutation_log(), tw.ref.enable_mutation_log()
    assert tw.port.enable_mutation_log() is lp
    ops = sc.ops()
    for op, arg in ops:
        tw(op, arg)
    assert (len(lp), lp.end) == (len(lr), lr.end) == (len(ops), len(ops))
    for cursor in (0, 3, len(ops)):
        gp, gr = lp.since(cursor), lr.since(cursor)
        assert [o for o, _ in gp] == [o for o, _ in gr]
        for (_, a), (_, b) in zip(gp, gr):
            np.testing.assert_array_equal(a, b)
    # a replica restored from the fit replays the log to the same state
    replica = GritIndex.restore(Twin(sc.fit_points(), sc.base.eps,
                                     sc.base.min_pts).port.snapshot())
    for op, arg in lp.since(0):
        getattr(replica, op)(arg)
    np.testing.assert_array_equal(replica.labels_arrival(),
                                  tw.port.labels_arrival())
    assert lp.truncate(2) == lr.truncate(2)
