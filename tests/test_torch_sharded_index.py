"""The port's sharded index (``repro_torch.index.ShardedGritIndex``),
its topology ops and the rebalancer, side by side with the JAX
package's.

Twins of ``tests/test_sharded_index.py`` and ``tests/test_topology.py``
on the distributed-serving scenarios, host-sharded (``fit_sharded(...,
engine="grit")``) as the reference's tier-1 tests are, plus fits through
the ``distributed`` engine on CPU shards.  Every case runs the same
numpy inputs through both packages and holds the port to the
reference bit for bit: host-mode predict labels (and each shard's
squared distances), ``labels_arrival`` / ``core_arrival`` after each
insert, delete, split and merge, the routing and mutation stats, the
rebalancer's decisions on one load sequence, and replica replay.
Snapshots (v3) cross-load both ways.
"""

import io

import numpy as np
import pytest

import repro.index as jindex
import repro.index.sharded as jsharded
from repro.dist.rebalance import (RebalancePolicy as JPolicy,
                                  Rebalancer as JRebalancer)
from repro_torch.core.dbscan import brute_dbscan
from repro_torch.core.validate import assert_labels_conformant, core_flags
from repro_torch.data.scenarios import (dist_serving_scenarios,
                                        get_dist_serving_scenario)
from repro_torch.dist.rebalance import RebalancePolicy, Rebalancer
from repro_torch.index import (LabelMap, ReplicaIndex,
                               ShardedGritIndex, fit_index, fit_sharded,
                               make_replicas)

DIST_SERVING = sorted(s.name for s in dist_serving_scenarios())
READOUTS = ("labels_arrival", "core_arrival", "arrival_live")
STATE = ("cuts", "owner_shard", "owner_row")
STATS = ("inserted", "n", "n_live", "touched_grids", "affected_grids",
         "changed_grids", "merge_checks", "dist_evals", "relabeled",
         "newly_core", "id_shifted", "shards_touched", "reconcile_unions")


def _pair(pts, eps, min_pts, **kw):
    """(reference, port) sharded fits of the same points."""
    return (jindex.fit_sharded(pts, eps, min_pts, **kw),
            fit_sharded(pts, eps, min_pts, device="cpu", **kw))


def assert_same(ref, got, what=""):
    """Read-outs, routing state, label map and per-shard registries of
    the two packages' indexes equal."""
    for f in READOUTS:
        np.testing.assert_array_equal(getattr(ref, f)(), getattr(got, f)(),
                                      err_msg=f"{what}: {f}")
    for f in STATE:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_array_equal(ref.label_map.parent,
                                  got.label_map.parent, err_msg=what)
    assert (ref.next_label, ref.localized, ref.ops_applied,
            ref.cut_history) == (got.next_label, got.localized,
                                 got.ops_applied, got.cut_history), what
    for k in range(ref.num_shards):
        for f in ("own_rows", "own_gids", "ghost_rows", "ghost_gids"):
            np.testing.assert_array_equal(getattr(ref, f)[k],
                                          getattr(got, f)[k],
                                          err_msg=f"{what}: {f}[{k}]")


def _oracle_assign(pts, core, labels, queries, eps):
    cpts = pts[core]
    clab = np.asarray(labels)[core]
    eps2 = float(eps) ** 2
    out = np.full(len(queries), -1, np.int64)
    valid = []
    for i, q in enumerate(queries):
        d2 = ((cpts - q) ** 2).sum(axis=1)
        j = d2.argmin()
        if d2[j] <= eps2:
            out[i] = clab[j]
            valid.append(set(clab[d2 == d2[j]].tolist()))
        else:
            valid.append({-1})
    return out, valid


@pytest.fixture(scope="module")
def fitted():
    """One (reference, port) pair per scenario (module memo; tests
    that mutate build their own)."""
    cache = {}

    def get(name):
        if name not in cache:
            ss = get_dist_serving_scenario(name)
            pts = ss.fit_points()
            cache[name] = (ss, pts) + _pair(pts, ss.base.eps,
                                            ss.base.min_pts, n_shards=4,
                                            engine="grit")
        return cache[name]

    return get


# --------------------------------------------------------------------------
# fit + predict
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", DIST_SERVING)
def test_fit_readout_equals_reference(name, fitted):
    ss, pts, ref, got = fitted(name)
    assert_same(ref, got, name)
    brute = brute_dbscan(pts, ss.base.eps, ss.base.min_pts)
    assert_labels_conformant(pts, ss.base.eps, ss.base.min_pts, brute,
                             got.labels_arrival())
    np.testing.assert_array_equal(
        got.core_arrival(), core_flags(pts, ss.base.eps, ss.base.min_pts))


def test_slabs_are_nonempty_and_ordered(fitted):
    _, pts, _, sidx = fitted("slab-serve-2d")
    assert sidx.num_shards >= 2
    assert (np.diff(sidx.cuts) > 0).all()
    for k in range(sidx.num_shards):
        assert len(sidx.own_rows[k]) > 0
    all_gids = np.concatenate(sidx.own_gids)
    assert len(all_gids) == len(pts) == len(np.unique(all_gids))


@pytest.mark.parametrize("name", DIST_SERVING)
def test_predict_host_equals_reference_and_oracle(name, fitted):
    """Slab-routed host predict: labels and routing stats equal the
    reference's, every shard's (labels, d2) too, and every label is
    the brute-oracle assignment, cut-band queries included."""
    ss, pts, ref, got = fitted(name)
    q = ss.query_batch()
    jst, tst = {}, {}
    want = ref.predict(q, mode="host", stats=jst)
    out = got.predict(q, mode="host", stats=tst)
    np.testing.assert_array_equal(want, out)
    assert jst == tst
    assert tst["multi_routed"] > 0
    assert tst["consulted"] == sum(tst["per_shard"])
    for k in range(got.num_shards):
        for a, b in zip(ref.shards[k].predict(q, mode="host",
                                              return_d2=True),
                        got.shards[k].predict(q, mode="host",
                                              return_d2=True)):
            np.testing.assert_array_equal(a, b)
    core = core_flags(pts, ss.base.eps, ss.base.min_pts)
    oracle, valid = _oracle_assign(pts, core, got.labels_arrival(), q,
                                   ss.base.eps)
    for i in range(len(q)):
        assert out[i] in valid[i], (i, out[i], valid[i])
    np.testing.assert_array_equal(out == -1, oracle == -1)


def test_predict_owner_only_away_from_cuts(fitted):
    ss, pts, _, sidx = fitted("slab-serve-2d")
    eps = ss.base.eps
    mid = (np.concatenate([[pts[:, 0].min()], sidx.cuts])
           + np.concatenate([sidx.cuts, [pts[:, 0].max()]])) / 2
    ok = [m for m in mid if (np.abs(sidx.cuts - m) > 2.5 * eps).all()]
    assert ok
    q = np.column_stack([np.repeat(ok, 3), np.tile(pts[:3, 1], len(ok))])
    stats = {}
    sidx.predict(q, mode="host", stats=stats)
    assert stats["multi_routed"] == 0 and stats["consulted"] == len(q)


def test_predict_outside_slab_range(fitted):
    ss, pts, _, sidx = fitted("slab-serve-2d")
    rng = np.random.default_rng(5)
    far = rng.uniform(-7e5, -5e5, size=(12, sidx.d))
    np.testing.assert_array_equal(sidx.predict(far, mode="host"),
                                  np.full(12, -1))
    core = core_flags(pts, ss.base.eps, ss.base.min_pts)
    ci = int(np.flatnonzero(core)[0])
    assert sidx.predict(pts[ci:ci + 1], mode="host")[0] == \
        sidx.labels_arrival()[ci]


@pytest.mark.parametrize("name", DIST_SERVING)
def test_predict_kernel_mode_matches_host(name, fitted):
    """Kernel mode on CPU shards (the plain ``row_min_batch``) routes
    per shard exactly like host mode, f32 knife-edge queries
    excluded."""
    ss, pts, _, sidx = fitted(name)
    q = ss.query_batch()
    host = sidx.predict(q, mode="host", device="cpu")
    stats = {}
    kern = sidx.predict(q, mode="kernel", device="cpu", stats=stats)
    assert stats["mode"] == "kernel"
    auto = sidx.predict(q, device="cpu", stats=stats)
    assert stats["mode"] == "host"          # "auto" on the CPU
    np.testing.assert_array_equal(auto, host)
    cpts = pts[core_flags(pts, ss.base.eps, ss.base.min_pts)]
    eps = ss.base.eps
    dmin = np.sqrt(((cpts[None] - q[:, None]) ** 2).sum(-1).min(1))
    decidable = np.abs(dmin - eps) > 1e-5 * eps
    np.testing.assert_array_equal(host[decidable], kern[decidable])


def test_predict_validates_inputs(fitted):
    _, _, _, sidx = fitted("slab-serve-2d")
    with pytest.raises(ValueError, match="queries must be"):
        sidx.predict(np.zeros((3, sidx.d + 2)))
    bad = np.zeros((2, sidx.d))
    bad[1, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        sidx.predict(bad)
    assert sidx.predict(np.zeros((0, sidx.d))).shape == (0,)


# --------------------------------------------------------------------------
# mutations, bit for bit against the reference
# --------------------------------------------------------------------------

def _stats_equal(a, b, what):
    assert {k: a[k] for k in STATS if k in a} == \
        {k: b[k] for k in STATS if k in b}, what


@pytest.mark.parametrize("name", DIST_SERVING)
def test_mutation_stream_equals_reference(name, fitted):
    """Inserts engineered across cuts, a delete, a split and a merge:
    after each, both packages' indexes hold the same read-outs and
    state, and the insert read-out is a from-scratch clustering."""
    ss, pts, _, _ = fitted(name)
    eps, mp = ss.base.eps, ss.base.min_pts
    ref, got = _pair(pts, eps, mp, n_shards=4, engine="grit")
    batches = ss.insert_batches()
    for i, b in enumerate(batches):
        _stats_equal(ref.insert(b), got.insert(b), f"insert {i}")
        assert_same(ref, got, f"insert {i}")
    union = np.concatenate([pts] + batches)
    assert_labels_conformant(union, eps, mp, brute_dbscan(union, eps, mp),
                             got.labels_arrival())
    np.testing.assert_array_equal(got.core_arrival(),
                                  core_flags(union, eps, mp))
    kill = np.concatenate([np.arange(0, len(pts), 7), [10 ** 9]])
    a, b = ref.delete(kill), got.delete(kill)
    assert (a["deleted"], a["demoted"], a["rejected"]) == \
        (b["deleted"], b["demoted"], b["rejected"])
    np.testing.assert_array_equal(a["rejected_ids"], b["rejected_ids"])
    assert_same(ref, got, "delete")
    for op, k in (("split_shard", 1), ("merge_shards", 2),
                  ("split_shard", 0)):
        a, b = getattr(ref, op)(k), getattr(got, op)(k)
        assert {x: a[x] for x in a if x != "t_total"} == \
            {x: b[x] for x in b if x != "t_total"}, op
        assert_same(ref, got, f"{op}({k})")
    q = ss.query_batch(seed=3)
    np.testing.assert_array_equal(ref.predict(q, mode="host"),
                                  got.predict(q, mode="host"))


def test_insert_bridge_across_cut_merges_labels(fitted):
    ss, pts, _, _ = fitted("slab-serve-2d")
    eps, min_pts = ss.base.eps, ss.base.min_pts
    ref, sidx = _pair(pts, eps, min_pts, n_shards=4, engine="grit")
    cut = sidx.cuts[1]
    rng = np.random.default_rng(9)
    y = float(pts[:, 1].mean())
    left = np.column_stack([
        rng.uniform(cut - 6 * eps, cut - 5 * eps, 4 * min_pts),
        rng.uniform(y - 0.2 * eps, y + 0.2 * eps, 4 * min_pts)])
    right = np.column_stack([
        rng.uniform(cut + 5 * eps, cut + 6 * eps, 4 * min_pts),
        rng.uniform(y - 0.2 * eps, y + 0.2 * eps, 4 * min_pts)])
    xs = np.arange(cut - 5 * eps, cut + 5 * eps, 0.5 * eps)
    chain = np.column_stack([xs, np.full(len(xs), y)])
    chain = np.repeat(chain, min_pts, axis=0) + rng.normal(
        scale=0.05 * eps, size=(len(xs) * min_pts, 2))
    for b in (np.concatenate([left, right]), chain):
        ref.insert(b)
        st = sidx.insert(b)
        assert_same(ref, sidx, "bridge")
    assert st["newly_core"] > 0
    la = sidx.labels_arrival()
    merged = set(la[len(pts):len(pts) + len(left) + len(right)].tolist())
    assert len(merged) == 1, merged
    union = np.concatenate([pts, left, right, chain])
    assert_labels_conformant(union, eps, min_pts,
                             brute_dbscan(union, eps, min_pts), la)


def test_insert_confined_to_touched_shards(fitted):
    ss, pts, _, _ = fitted("slab-serve-2d")
    eps = ss.base.eps
    sidx = fit_sharded(pts, eps, ss.base.min_pts, n_shards=4,
                       engine="grit", device="cpu")
    lo, hi = sidx.cuts[0] + 3 * eps, sidx.cuts[1] - 3 * eps
    assert hi > lo
    rng = np.random.default_rng(3)
    batch = np.column_stack([
        rng.uniform(lo, hi, 12),
        rng.uniform(pts[:, 1].min(), pts[:, 1].max(), 12)])
    before = [s.n for s in sidx.shards]
    st = sidx.insert(batch)
    assert st["shards_touched"] == [1]
    after = [s.n for s in sidx.shards]
    assert after[1] == before[1] + 12
    assert [a for i, a in enumerate(after) if i != 1] == \
        [b for i, b in enumerate(before) if i != 1]


def test_insert_outside_slab_range_extends_end_slabs(fitted):
    ss, pts, _, _ = fitted("slab-serve-2d")
    eps, min_pts = ss.base.eps, ss.base.min_pts
    ref, sidx = _pair(pts, eps, min_pts, n_shards=3, engine="grit")
    rng = np.random.default_rng(11)
    below = pts.min(axis=0) - 8 * eps
    above = pts.max(axis=0) + 8 * eps
    batch = np.concatenate([
        below[None, :] + rng.uniform(0, eps, size=(6, sidx.d)),
        above[None, :] + rng.uniform(0, eps, size=(6, sidx.d))])
    st = sidx.insert(batch)
    _stats_equal(ref.insert(batch), st, "outside")
    assert_same(ref, sidx, "outside")
    assert set(st["shards_touched"]) == {0, sidx.num_shards - 1}
    union = np.concatenate([pts, batch])
    assert_labels_conformant(union, eps, min_pts,
                             brute_dbscan(union, eps, min_pts),
                             sidx.labels_arrival())


def test_insert_validates_inputs(fitted):
    _, _, _, sidx0 = fitted("slab-serve-2d")
    sidx = ShardedGritIndex.restore(sidx0.snapshot())
    with pytest.raises(ValueError, match="insert batch"):
        sidx.insert(np.zeros((3, sidx.d + 1)))
    bad = np.zeros((2, sidx.d))
    bad[0, 1] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        sidx.insert(bad)
    st = sidx.insert(np.zeros((0, sidx.d)))
    assert st["inserted"] == 0 and st["newly_core"] == 0
    assert st["shards_touched"] == [] and "t_total" in st


# --------------------------------------------------------------------------
# snapshots: round trip and cross-loading
# --------------------------------------------------------------------------

def test_snapshot_roundtrip_and_cross_load_both_ways(fitted):
    ss, pts, ref, sidx = fitted("slab-serve-3d")
    snap = sidx.snapshot()
    assert all(isinstance(v, np.ndarray) for v in snap.values())
    jsnap = ref.snapshot()
    assert set(snap) == set(jsnap)
    for k in snap:
        np.testing.assert_array_equal(snap[k], jsnap[k], err_msg=k)
    q = ss.query_batch()
    want = ref.predict(q, mode="host")
    for writer, reader in ((sidx, jsharded.ShardedGritIndex),
                           (ref, ShardedGritIndex),
                           (sidx, ShardedGritIndex)):
        buf = io.BytesIO()
        writer.save(buf)
        buf.seek(0)
        back = reader.load(buf)
        assert back.num_shards == sidx.num_shards
        np.testing.assert_array_equal(back.cuts, sidx.cuts)
        np.testing.assert_array_equal(back.labels_arrival(),
                                      sidx.labels_arrival())
        np.testing.assert_array_equal(back.predict(q, mode="host"), want)
    # a restored index keeps serving inserts exactly
    b = ss.insert_batches()[0]
    back = ShardedGritIndex.restore(ref.snapshot())
    back.insert(b)
    union = np.concatenate([pts, b])
    assert_labels_conformant(
        union, ss.base.eps, ss.base.min_pts,
        brute_dbscan(union, ss.base.eps, ss.base.min_pts),
        back.labels_arrival())


def test_snapshot_version_checked(fitted):
    _, _, _, sidx = fitted("slab-serve-2d")
    snap = sidx.snapshot()
    snap["sharded_version"] = np.asarray([99], np.int64)
    with pytest.raises(ValueError, match="sharded snapshot version"):
        ShardedGritIndex.restore(snap)


# --------------------------------------------------------------------------
# construction edge cases, and fits through other engines
# --------------------------------------------------------------------------

def test_single_shard_degenerates_to_plain_index_semantics():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 100, size=(150, 2))
    ref, sidx = _pair(pts, 5.0, 4, n_shards=1)
    assert sidx.num_shards == 1 and len(sidx.cuts) == 0
    assert_same(ref, sidx)
    assert_labels_conformant(pts, 5.0, 4, brute_dbscan(pts, 5.0, 4),
                             sidx.labels_arrival())


def test_empty_slabs_coalesce():
    rng = np.random.default_rng(2)
    pts = np.column_stack([rng.uniform(50, 52, 120),
                           rng.uniform(0, 100, 120)])
    ref, sidx = _pair(pts, 8.0, 4, n_shards=6)
    assert_same(ref, sidx)
    for k in range(sidx.num_shards):
        assert len(sidx.own_rows[k]) > 0
    assert_labels_conformant(pts, 8.0, 4, brute_dbscan(pts, 8.0, 4),
                             sidx.labels_arrival())


def test_fit_sharded_from_device_engine():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 100, size=(200, 2))
    ref, sidx = _pair(pts, 6.0, 4, n_shards=3, engine="device")
    assert_same(ref, sidx)
    assert_labels_conformant(pts, 6.0, 4, brute_dbscan(pts, 6.0, 4),
                             sidx.labels_arrival())


@pytest.mark.parametrize("name", DIST_SERVING)
def test_fit_sharded_through_the_distributed_engine(name):
    """``engine="distributed"``: on one CPU device the fit equals the
    reference's (which runs its engine on the one JAX device) and so
    does the whole index; on four CPU shards the labels are another
    numbering of the same clustering, and the index serves and mutates
    exactly."""
    ss = get_dist_serving_scenario(name)
    pts = ss.fit_points()
    eps, mp = ss.base.eps, ss.base.min_pts
    ref = jindex.fit_sharded(pts, eps, mp, n_shards=4, engine="distributed")
    one = fit_sharded(pts, eps, mp, n_shards=4, devices=["cpu"])
    assert_same(ref, one, name)
    four = fit_sharded(pts, eps, mp, n_shards=4, engine="distributed",
                       device="cpu")
    brute = brute_dbscan(pts, eps, mp)
    assert_labels_conformant(pts, eps, mp, brute, four.labels_arrival())
    np.testing.assert_array_equal(four.core_arrival(), ref.core_arrival())
    q = ss.query_batch()
    np.testing.assert_array_equal(ref.predict(q, mode="host") >= 0,
                                  four.predict(q, mode="host") >= 0)
    b = ss.insert_batches()[0]
    four.insert(b)
    union = np.concatenate([pts, b])
    assert_labels_conformant(union, eps, mp, brute_dbscan(union, eps, mp),
                             four.labels_arrival())


def test_from_fit_without_core_flags_identifies_cores():
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.normal(50, 3.0, size=(120, 2)),
                          rng.uniform(0, 100, size=(40, 2))])
    eps, min_pts = 4.0, 5
    lab = brute_dbscan(pts, eps, min_pts)
    sidx = ShardedGritIndex.from_global_fit(pts, eps, min_pts, labels=lab,
                                            core=None, n_shards=3)
    np.testing.assert_array_equal(sidx.core_arrival(),
                                  core_flags(pts, eps, min_pts))
    ref = jsharded.ShardedGritIndex.from_global_fit(
        pts, eps, min_pts, labels=lab, core=None, n_shards=3)
    assert_same(ref, sidx)


def test_label_map_union_find_equals_reference():
    a, b = LabelMap(12), jsharded.LabelMap(12)
    for x, y in ((3, 7), (7, 1), (9, 10), (10, 3), (5, 5), (11, 0)):
        assert a.union(x, y) == b.union(x, y)
    a.grow(15)
    b.grow(15)
    lab = np.asarray([-1, 0, 3, 7, 9, 10, 11, 14, 5])
    np.testing.assert_array_equal(a.resolve(lab), b.resolve(lab))
    np.testing.assert_array_equal(a.parent, b.parent)


# --------------------------------------------------------------------------
# topology ops (twins of tests/test_topology.py)
# --------------------------------------------------------------------------

EPS, MIN_PTS = 0.6, 6


def canon(labels):
    out = np.full(len(labels), -1, np.int64)
    m = {}
    for i, v in enumerate(labels):
        if v >= 0:
            out[i] = m.setdefault(int(v), len(m))
    return out


@pytest.fixture()
def blobs():
    rng = np.random.default_rng(7)
    return np.concatenate([
        rng.normal((0, 0), 1.0, (400, 2)),
        rng.normal((8, 1), 1.2, (400, 2)),
        rng.normal((4, -3), 0.8, (300, 2)),
    ])


@pytest.fixture()
def trio(blobs):
    """(reference, mutated, never-rebalanced): topology ops go to the
    reference and to the port's first index, the second stays put."""
    ref, got = _pair(blobs, EPS, MIN_PTS, n_shards=3)
    return ref, got, fit_sharded(blobs, EPS, MIN_PTS, n_shards=3,
                                 device="cpu")


class TestSplitMergeExactness:
    def test_split_is_bit_identical(self, trio):
        ref, sidx, still = trio
        st = sidx.split_shard(1)
        ref.split_shard(1)
        assert st["num_shards"] == 4
        assert st["n_left"] > 0 and st["n_right"] > 0
        assert_same(ref, sidx)
        assert np.array_equal(sidx.labels_arrival(), still.labels_arrival())
        assert np.array_equal(sidx.core_arrival(), still.core_arrival())

    def test_merge_is_bit_identical(self, trio):
        ref, sidx, still = trio
        st = sidx.merge_shards(0)
        ref.merge_shards(0)
        assert st["num_shards"] == 2
        assert_same(ref, sidx)
        assert np.array_equal(sidx.labels_arrival(), still.labels_arrival())

    def test_split_merge_round_trip_restores_topology(self, trio):
        ref, sidx, still = trio
        cuts0 = sidx.cuts.copy()
        st = sidx.split_shard(1)
        st2 = sidx.merge_shards(1)
        ref.split_shard(1)
        ref.merge_shards(1)
        assert st2["cut"] == st["cut"]
        assert np.array_equal(sidx.cuts, cuts0)
        assert_same(ref, sidx)
        assert np.array_equal(sidx.labels_arrival(), still.labels_arrival())
        assert [op for op, _, _ in sidx.cut_history] == ["split", "merge"]

    def test_split_straddling_cross_cut_cluster(self):
        rng = np.random.default_rng(3)
        strip = np.column_stack([rng.uniform(0.0, 10.0, 2000),
                                 rng.normal(0.0, 0.3, 2000)])
        ref, sidx = _pair(strip, EPS, MIN_PTS, n_shards=2)
        labs = sidx.labels_arrival()
        assert len(np.unique(labs[labs >= 0])) == 1
        for k in (0, 2):
            st = sidx.split_shard(k)
            ref.split_shard(k)
            assert 0.0 < st["cut"] < 10.0
            assert np.array_equal(sidx.labels_arrival(), labs)
            assert_same(ref, sidx, f"split {k}")

    def test_insert_into_locally_disconnected_cluster(self):
        xs = np.arange(0.0, 10.05, 0.1)
        ys = np.arange(0.2, 5.85, 0.1)
        u = np.concatenate([
            np.column_stack([xs, np.zeros_like(xs)]),
            np.column_stack([xs, np.full_like(xs, 6.0)]),
            np.column_stack([np.full_like(ys, 10.0), ys]),
            [[2.05, -0.59], [5.05, -0.59], [8.05, -0.59]],
        ])
        single = fit_index(u, EPS, MIN_PTS, engine="grit", device="cpu")
        labs = single.labels_arrival()
        assert len(np.unique(labs[labs >= 0])) == 1
        for pre_split in (False, True):
            plain = fit_index(u, EPS, MIN_PTS, engine="grit", device="cpu")
            ref, sidx = _pair(u, EPS, MIN_PTS, n_shards=2)
            assert sidx.cuts[0] < 10.0 - 2 * EPS
            if pre_split:
                sidx.split_shard(0)
                ref.split_shard(0)
            batch = np.asarray([[1.0, 0.05], [3.0, 5.95]])
            plain.insert(batch)
            sidx.insert(batch)
            ref.insert(batch)
            out = sidx.labels_arrival()
            assert out.min() >= -1
            assert np.array_equal(out, plain.labels_arrival())
            assert np.array_equal(sidx.core_arrival(), plain.core_arrival())
            assert_same(ref, sidx, f"pre_split={pre_split}")

    def test_predict_stream_identical_after_ops(self, trio):
        ref, sidx, still = trio
        q = np.random.default_rng(11).normal((4, -1), 3.0, (300, 2))
        for op in ("split_shard", "merge_shards"):
            getattr(sidx, op)(1)
            getattr(ref, op)(1)
            out = sidx.predict(q, device="cpu")
            assert np.array_equal(out, still.predict(q, device="cpu"))
            assert np.array_equal(out, ref.predict(q))

    def test_ops_compose_with_inserts(self, trio):
        ref, sidx, still = trio
        rng = np.random.default_rng(5)
        b1 = rng.normal((8, 1), 1.2, (60, 2))
        b2 = rng.normal((0, 0), 1.0, (60, 2))
        for ix in (ref, sidx):
            ix.insert(b1)
            ix.split_shard(2)
            ix.insert(b2)
            ix.merge_shards(2)
        still.insert(b1)
        still.insert(b2)
        assert_same(ref, sidx)
        assert np.array_equal(sidx.labels_arrival(), still.labels_arrival())
        assert np.array_equal(sidx.core_arrival(), still.core_arrival())

    def test_localized_regime_partition_exact(self, trio):
        ref, sidx, still = trio
        dead = np.arange(0, 80, dtype=np.int64)
        for ix in (ref, sidx, still):
            ix.delete(dead)
        assert sidx.localized
        for ix in (ref, sidx):
            ix.split_shard(1)
            ix.merge_shards(1)
        assert_same(ref, sidx)
        assert np.array_equal(canon(sidx.labels_arrival()),
                              canon(still.labels_arrival()))
        assert np.array_equal(sidx.core_arrival(), still.core_arrival())

    def test_snapshot_split_merge_restore_round_trip(self, trio):
        ref, sidx, still = trio
        back = ShardedGritIndex.restore(sidx.snapshot())
        back.split_shard(1)
        back.merge_shards(1)
        final = ShardedGritIndex.restore(back.snapshot())
        jfinal = jsharded.ShardedGritIndex.restore(back.snapshot())
        assert np.array_equal(final.labels_arrival(),
                              still.labels_arrival())
        assert final.cut_history == back.cut_history == jfinal.cut_history
        assert_same(jfinal, final)


class TestTopologyValidation:
    def test_split_out_of_range(self, trio):
        with pytest.raises(ValueError):
            trio[1].split_shard(7)

    def test_merge_needs_adjacent(self, trio):
        sidx = trio[1]
        with pytest.raises(ValueError):
            sidx.merge_shards(0, 2)
        with pytest.raises(ValueError):
            sidx.merge_shards(2)

    def test_unsplittable_single_column(self):
        rng = np.random.default_rng(0)
        pts = np.column_stack([5.0 + 0.1 * rng.random(60),
                               rng.normal(0, 3.0, 60)])
        sidx = fit_sharded(pts, 1.0, 3, n_shards=2, device="cpu")
        with pytest.raises(ValueError, match="unsplittable|no interior"):
            sidx.split_shard(0)


class TestReplica:
    def test_sharded_replica_replays_topology(self, blobs):
        """Twin of the reference's: replicas of a sharded primary replay
        inserts, splits and merges and answer as the primary does --
        and as the reference's primary does after the same ops."""
        rng = np.random.default_rng(4)
        ref, sp = _pair(blobs, EPS, MIN_PTS, n_shards=3)
        reps = make_replicas(sp, 2)
        ins = [rng.normal((8, 1), 1.2, (50, 2)),
               rng.normal((0, 0), 1.0, (50, 2))]
        for ix in (ref, sp):
            ix.insert(ins[0])
            ix.split_shard(0)
            ix.insert(ins[1])
            ix.delete(np.arange(0, 40, 4))
            ix.merge_shards(0)
        assert reps[0].lag == 5
        q = rng.normal((4, -1), 3.0, (200, 2))
        want = sp.predict(q, device="cpu")
        np.testing.assert_array_equal(want, ref.predict(q))
        for rep in reps:
            assert np.array_equal(rep.predict(q, device="cpu"), want)
            assert np.array_equal(rep.labels_arrival(), sp.labels_arrival())
            assert rep.index.cut_history == sp.cut_history
            assert rep.lag == 0
            assert_same(sp, rep.index)
        assert isinstance(reps[0], ReplicaIndex)


class TestRebalancer:
    def test_decisions_equal_reference_on_one_load_sequence(self, blobs):
        """One load sequence through both packages' rebalancers, each
        driving its own package's index: the same ops at the same
        steps, and the same indexes after them."""
        ref, sidx = _pair(blobs, EPS, MIN_PTS, n_shards=3)
        pol = dict(period=2, hot_factor=1.8, cold_factor=0.5)
        jrb, trb = JRebalancer(JPolicy(**pol)), Rebalancer(
            RebalancePolicy(**pol))
        rng = np.random.default_rng(13)
        ops = []
        for step in range(24):
            k = sidx.num_shards
            loads = rng.gamma(1.0, 10.0, k)
            loads[step % k] *= 6.0 if step % 5 else 0.05
            jrb.observe(loads)
            trb.observe(loads)
            assert jrb.imbalance() == trb.imbalance()
            a = jrb.maybe_rebalance(ref)
            b = trb.maybe_rebalance(sidx)
            assert (a is None) == (b is None), step
            if a is not None:
                assert {x: a[x] for x in a if x != "t_total"} == \
                    {x: b[x] for x in b if x != "t_total"}
                ops.append((a["op"], a["shard"]))
            assert_same(ref, sidx, f"step {step}")
        assert {"split", "merge"} <= {op for op, _ in ops}, ops
        assert jrb._unsplittable == trb._unsplittable

    def test_splits_hottest_after_period(self, blobs):
        sidx = fit_sharded(blobs, EPS, MIN_PTS, n_shards=3, device="cpu")
        rb = Rebalancer(RebalancePolicy(period=2, hot_factor=2.0))
        loads = [100.0, 10.0, 10.0]
        rb.observe(loads)
        assert rb.maybe_rebalance(sidx) is None
        rb.observe(loads)
        st = rb.maybe_rebalance(sidx)
        assert st is not None and st["op"] == "split" and st["shard"] == 0
        assert sidx.num_shards == 4
        assert rb.history == [st]
        assert rb.load is None

    def test_merges_coldest_adjacent_pair(self, blobs):
        sidx = fit_sharded(blobs, EPS, MIN_PTS, n_shards=3, device="cpu")
        rb = Rebalancer(RebalancePolicy(period=1, hot_factor=100.0,
                                        cold_factor=0.5))
        rb.observe([100.0, 1.0, 2.0])
        rb.steps = rb.policy.period + 1
        st = rb.maybe_rebalance(sidx)
        assert st is not None and st["op"] == "merge" and st["shard"] == 1
        assert sidx.num_shards == 2

    def test_no_op_when_balanced(self, blobs):
        sidx = fit_sharded(blobs, EPS, MIN_PTS, n_shards=3, device="cpu")
        rb = Rebalancer(RebalancePolicy(period=1))
        for _ in range(4):
            rb.observe([10.0, 11.0, 9.0])
        assert rb.maybe_rebalance(sidx) is None
        assert sidx.num_shards == 3

    def test_respects_max_shards(self, blobs):
        sidx = fit_sharded(blobs, EPS, MIN_PTS, n_shards=3, device="cpu")
        rb = Rebalancer(RebalancePolicy(period=1, max_shards=3))
        for _ in range(3):
            rb.observe([100.0, 1.0, 1.0])
        assert rb.maybe_rebalance(sidx) is None or \
            rb.history[0]["op"] != "split"
        assert sidx.num_shards <= 3

    def test_shard_count_change_resets_ewma(self):
        rb = Rebalancer()
        rb.observe([1.0, 2.0, 3.0])
        rb.observe([10.0, 20.0])
        assert np.array_equal(rb.load, [10.0, 20.0])

    def test_imbalance_gauge_math(self):
        rb = Rebalancer()
        rb.observe([30.0, 10.0, 20.0])
        assert rb.imbalance() == pytest.approx(30.0 / 20.0)

    def test_unsplittable_falls_through(self):
        rng = np.random.default_rng(0)
        pts = np.column_stack([
            np.concatenate([5.0 + 0.1 * rng.random(60),
                            rng.uniform(20.0, 30.0, 60)]),
            rng.normal(0, 3.0, 120)])
        sidx = fit_sharded(pts, 1.0, 3, n_shards=2, device="cpu")
        assert sidx.num_shards == 2
        rb = Rebalancer(RebalancePolicy(period=1, hot_factor=1.5,
                                        cold_factor=0.0))
        for _ in range(3):
            rb.observe([100.0, 1.0])
        assert rb.maybe_rebalance(sidx) is None
        assert 0 in rb._unsplittable
