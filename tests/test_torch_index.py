"""Port fitted index vs the JAX package (twin of ``tests/test_index.py``
and ``tests/test_snapshot_io.py``): the same seeded scenario data and
the same fit go into ``repro.index.GritIndex`` and
``repro_torch.index.GritIndex``, and

* the scenario generators draw the same arrays;
* ``from_fit`` builds equal arrays;
* host-mode predict is bit-identical (labels and float64 d2);
* kernel mode (the plain version, ``device="cpu"``) equals the
  reference's kernel mode on every decidable query (float32 may flip a
  query within 1e-5 relative of eps), and its caps grow the same way;
* ``return_index`` works for every port engine;
* snapshots cross between the packages in both directions bit for bit,
  and v1 snapshots restore.
"""

import io

import numpy as np
import pytest
import torch

import repro.data.scenarios as jsc
from repro.core.dbscan import grit_dbscan
from repro.index import GritIndex as JIndex
import repro_torch.data.scenarios as tsc
from repro_torch.core.device_dbscan import GritCaps
from repro_torch.engine import cluster
from repro_torch.index import GritIndex, fit_index
from repro_torch.index.snapshot_io import (check_version, load_snapshot,
                                           save_snapshot)

SERVING = sorted(s.name for s in tsc.serving_scenarios())
# scenario kind -> (getter, name -> scenario map), in both packages
KINDS = {"serving": ("get_serving_scenario", "serving_scenario_map"),
         "churn": ("get_churn_scenario", "churn_scenario_map")}
FIELDS = ("points", "arrival", "ids", "starts", "counts", "core", "labels",
          "mins", "id_shift", "alive", "live_counts")


@pytest.fixture(scope="module")
def fitted():
    """Per serving scenario: (scenario, points, reference index, port
    index), both built by ``from_fit`` from one host fit."""
    memo = {}

    def get(name):
        if name not in memo:
            ss = tsc.get_serving_scenario(name)
            pts = ss.fit_points()
            eps, mp = ss.base.eps, ss.base.min_pts
            res = grit_dbscan(pts, eps, mp)
            memo[name] = (ss, pts,
                          JIndex.from_fit(pts, eps, mp, res.labels,
                                          core=res.core),
                          GritIndex.from_fit(pts, eps, mp, res.labels,
                                             core=res.core))
        return memo[name]
    return get


def _assert_same_state(port, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert (port.eps, port.min_pts, port.side, port.next_label,
            port.next_arrival) == (ref.eps, ref.min_pts, ref.side,
                                   ref.next_label, ref.next_arrival)
    if port.merge_edges is None or ref.merge_edges is None:
        assert port.merge_edges is None and ref.merge_edges is None
    else:
        np.testing.assert_array_equal(port.merge_edges, ref.merge_edges)


def _decidable(pts, core, q, eps):
    cpts = pts[np.asarray(core)]
    dmin = np.sqrt(np.array([((cpts - x) ** 2).sum(axis=1).min()
                             for x in q]))
    return np.abs(dmin - eps) > 1e-5 * eps


# --------------------------------------------------------------------------
# scenarios, from_fit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,name", [
    ("serving", s.name) for s in tsc.serving_scenarios()] + [
    ("churn", s.name) for s in tsc.churn_scenarios()])
def test_serving_and_churn_generators_draw_the_same_arrays(kind, name):
    get, catalogue = KINDS[kind]
    got, want = getattr(tsc, get)(name), getattr(jsc, get)(name)
    assert (got.base.eps, got.base.min_pts) == (want.base.eps,
                                                 want.base.min_pts)
    for seed in (0, 3):
        np.testing.assert_array_equal(got.fit_points(seed),
                                      want.fit_points(seed))
        if kind == "churn":
            gops, wops = got.ops(seed), want.ops(seed)
            assert [o for o, _ in gops] == [o for o, _ in wops]
            for (_, g), (_, w) in zip(gops, wops):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_equal(got.query_batch(seed),
                                          want.query_batch(seed))
            for g, w in zip(got.insert_batches(seed),
                            want.insert_batches(seed)):
                np.testing.assert_array_equal(g, w)
    assert sorted(getattr(tsc, catalogue)()) == \
        sorted(getattr(jsc, catalogue)())


@pytest.mark.parametrize("base", ["cross-slab-2d", "cross-slab-3d",
                                  "blobs-2d"])
def test_slab_band_generators_draw_the_same_arrays(base):
    """The cut-band query and insert generators (the traffic of the
    reference's distributed-serving catalogue) draw the reference's
    numbers from the same seed."""
    sc = tsc.get_scenario(base)
    pts = sc.points(seed=0)
    np.testing.assert_array_equal(tsc._quantile_cuts(pts),
                                  jsc._quantile_cuts(pts))
    for step in range(3):
        got = [tsc._queries_slab_band(np.random.default_rng(step), pts, sc,
                                      64),
               tsc._insert_slab_drift(np.random.default_rng(step), pts, sc,
                                      40, step, 3)]
        want = [jsc._queries_slab_band(np.random.default_rng(step), pts,
                                       jsc.get_scenario(base), 64),
                jsc._insert_slab_drift(np.random.default_rng(step), pts,
                                       jsc.get_scenario(base), 40, step, 3)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", SERVING)
def test_from_fit_arrays_equal(name, fitted):
    ss, pts, ref, port = fitted(name)
    _assert_same_state(port, ref)
    gp, gr = port.fit_grid, ref.fit_grid
    np.testing.assert_array_equal(gp.ids, gr.ids)
    np.testing.assert_array_equal(gp.point_grid, gr.point_grid)
    # without core flags both identify cores from the grid partition
    res = grit_dbscan(pts, ss.base.eps, ss.base.min_pts)
    _assert_same_state(
        GritIndex.from_fit(pts, ss.base.eps, ss.base.min_pts, res.labels),
        JIndex.from_fit(pts, ss.base.eps, ss.base.min_pts, res.labels))


# --------------------------------------------------------------------------
# predict
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVING)
def test_predict_host_is_bit_identical_to_reference(name, fitted):
    ss, pts, ref, port = fitted(name)
    q = ss.query_batch()
    for chunk in (2048, 7):
        sp, sr = {}, {}
        lp, dp = port.predict(q, mode="host", return_d2=True, chunk=chunk,
                              stats=sp)
        lr, dr = ref.predict(q, mode="host", return_d2=True, chunk=chunk,
                             stats=sr)
        np.testing.assert_array_equal(lp, lr)
        np.testing.assert_array_equal(dp, dr)         # inf included
        assert sp == sr
    # the oracle rule: noise exactly where no core lies within eps
    cpts = pts[ref.core_arrival()]
    near = np.array([((cpts - x) ** 2).sum(1).min() for x in q])
    np.testing.assert_array_equal(lp == -1, near > ss.base.eps ** 2)


@pytest.mark.parametrize("name", SERVING)
def test_predict_kernel_mode_equals_reference_on_decidable_queries(
        name, fitted):
    ss, pts, ref, port = fitted(name)
    q = ss.query_batch()
    sp, sr = {}, {}
    lp, dp = port.predict(q, mode="kernel", device="cpu", return_d2=True,
                          stats=sp)
    lr, dr = ref.predict(q, mode="kernel", return_d2=True, stats=sr)
    ok = _decidable(pts, ref.core_arrival(), q, ss.base.eps)
    np.testing.assert_array_equal(lp[ok], lr[ok])
    np.testing.assert_array_equal(lp[ok], port.predict(q, mode="host")[ok])
    np.testing.assert_allclose(dp, dr, rtol=1e-5)
    for k in ("mode", "groups", "candidates", "caps", "caps_grew"):
        assert sp[k] == sr[k], k


def test_predict_caps_grow_the_same_way():
    ss = tsc.get_serving_scenario("drift-2d")
    pts = ss.fit_points()
    res = grit_dbscan(pts, ss.base.eps, ss.base.min_pts)
    port = GritIndex.from_fit(pts, ss.base.eps, ss.base.min_pts, res.labels,
                              core=res.core)
    ref = JIndex.from_fit(pts, ss.base.eps, ss.base.min_pts, res.labels,
                          core=res.core)
    for n in (16, 120, 16, 40):
        sp, sr = {}, {}
        port.predict(ss.query_batch(n=n), mode="kernel", device="cpu",
                     stats=sp)
        ref.predict(ss.query_batch(n=n), mode="kernel", stats=sr)
        assert (sp["caps"], sp["caps_grew"]) == (sr["caps"], sr["caps_grew"])
        assert port.predict_caps.__dict__ == ref.predict_caps.__dict__
    assert not sp["caps_grew"]


def test_default_device_is_the_card(fitted, monkeypatch):
    """``predict`` / ``ensure_device_state`` default to the CUDA device
    and raise without one; ``device="cpu"`` makes auto pick host."""
    ss, _, _, port = fitted("drift-2d")
    q = ss.query_batch(n=16)
    idx = GritIndex.restore(port.snapshot())
    st = {}
    idx.predict(q, device="cpu", stats=st)
    assert st["mode"] == "host"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            idx.predict(q)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            idx.predict(q, mode="kernel")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            idx.ensure_device_state()
        assert idx.device_state is None
    # with a card present, auto picks the kernel mode
    from repro_torch.engine import adaptive
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert adaptive.resolve_device(None).type == "cuda"
    seen = {}
    monkeypatch.setattr(GritIndex, "_predict_kernel",
                        lambda self, q, stats, device: seen.setdefault(
                            "kernel", (np.full(len(q), -1), np.zeros(len(q)))))
    idx.predict(q)
    assert "kernel" in seen


def test_predict_validates_inputs(fitted):
    _, _, _, port = fitted("drift-2d")
    with pytest.raises(ValueError, match="queries must be"):
        port.predict(np.zeros((3, 5)), device="cpu")
    bad = np.zeros((2, 2))
    bad[1, 0] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        port.predict(bad, device="cpu")
    assert port.predict(np.zeros((0, 2)), device="cpu").shape == (0,)
    with pytest.raises(ValueError, match="unknown predict mode"):
        port.predict(np.zeros((1, 2)), mode="nope")


def test_insert_outside_bbox_shifts_like_the_reference(fitted):
    ss, pts, ref, port = fitted("drift-2d")
    port, ref = GritIndex.restore(port.snapshot()), JIndex.restore(
        ref.snapshot())
    below = pts.min(axis=0) - 10 * ss.base.eps
    batch = below[None, :] + np.random.default_rng(0).uniform(
        0, ss.base.eps, size=(8, port.d))
    sp, sr = port.insert(batch), ref.insert(batch)
    assert sp["id_shifted"] and sr["id_shifted"]
    _assert_same_state(port, ref)
    np.testing.assert_array_equal(port.query_ids(port.points),
                                  np.repeat(port.ids, port.counts, axis=0))


# --------------------------------------------------------------------------
# return_index, fit_index
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["brute", "grit", "grit-ldf", "device",
                                    "device-kernels"])
def test_return_index_for_every_port_engine(engine):
    sc = tsc.scenario_map()["blobs-2d"]
    pts = sc.points()
    res = cluster(pts, sc.eps, sc.min_pts, engine=engine, device="cpu",
                  return_index=True)
    idx = res.index
    assert isinstance(idx, GritIndex)
    np.testing.assert_array_equal(idx.labels_arrival(), res.labels)
    np.testing.assert_array_equal(idx.core_arrival(), res.core)
    ci = int(np.flatnonzero(res.core)[0])
    assert idx.predict(pts[ci:ci + 1], mode="host")[0] == res.labels[ci]
    if engine.startswith("device"):
        assert idx.caps == GritCaps(**res.attempts[-1]["caps"])
        assert GritIndex.restore(idx.snapshot()).caps == idx.caps
    # the same labels through the reference's from_fit give equal arrays
    _assert_same_state(idx, JIndex.from_fit(pts, sc.eps, sc.min_pts,
                                            res.labels, core=res.core))


def test_fit_index_helper():
    sc = tsc.scenario_map()["blobs-2d"]
    idx = fit_index(sc.points(), sc.eps, sc.min_pts, engine="grit",
                    device="cpu")
    assert isinstance(idx, GritIndex) and idx.n == len(sc.points())


# --------------------------------------------------------------------------
# snapshots across the packages
# --------------------------------------------------------------------------

def _mutated_pair(fitted):
    """Reference and port index after the same inserts and deletes (so
    the snapshot carries tombstones and a merge graph)."""
    ss, _, ref, port = fitted("query-heavy-3d")
    port, ref = GritIndex.restore(port.snapshot()), JIndex.restore(
        ref.snapshot())
    b = ss.insert_batches()[0]
    port.insert(b), ref.insert(b)
    ids = np.arange(0, port.next_arrival, 7)
    port.delete(ids), ref.delete(ids)
    return ss, ref, port


@pytest.mark.parametrize("direction", ["reference-to-port",
                                       "port-to-reference"])
def test_snapshot_crosses_packages_bit_exactly(direction, fitted):
    ss, ref, port = _mutated_pair(fitted)
    src, dst_cls = ((ref, GritIndex) if direction == "reference-to-port"
                    else (port, JIndex))
    buf = io.BytesIO()
    src.save(buf)
    buf.seek(0)
    back = dst_cls.load(buf)
    sb, ss_ = back.snapshot(), src.snapshot()
    assert set(sb) == set(ss_)
    for k in sb:
        np.testing.assert_array_equal(sb[k], ss_[k], err_msg=k)
    assert back.caps == src.caps
    q = ss.query_batch()
    lb, db = back.predict(q, mode="host", return_d2=True)
    ls, ds = src.predict(q, mode="host", return_d2=True)
    np.testing.assert_array_equal(lb, ls)
    np.testing.assert_array_equal(db, ds)
    # both keep serving mutations identically after the crossing
    nxt = ss.insert_batches()[1]
    back.insert(nxt), src.insert(nxt)
    np.testing.assert_array_equal(back.labels_arrival(), src.labels_arrival())
    np.testing.assert_array_equal(back.merge_edges, src.merge_edges)


@pytest.mark.parametrize("origin", ["reference", "port"])
def test_v1_snapshot_restores(origin, fitted):
    """A v1 snapshot (no mutation-plane arrays) restores in the port:
    everything alive, merge graph rebuilt lazily and equal."""
    _, _, ref, port = fitted("drift-2d")
    snap = (ref if origin == "reference" else port).snapshot()
    for k in ("alive", "live_counts", "merge_edges", "has_merge_graph"):
        snap.pop(k)
    snap["version"] = np.asarray([1], np.int64)
    back = GritIndex.restore(snap)
    np.testing.assert_array_equal(back.labels, port.labels)
    assert back.alive.all() and back.merge_edges is None
    np.testing.assert_array_equal(back.ensure_merge_graph(),
                                  JIndex.restore(ref.snapshot())
                                  .ensure_merge_graph())


def test_snapshot_version_guards(fitted, tmp_path):
    _, _, _, port = fitted("drift-2d")
    snap = port.snapshot()
    assert int(snap["version"][0]) == 2
    snap["version"] = np.asarray([99], np.int64)
    with pytest.raises(ValueError, match=r"version 99"):
        GritIndex.restore(snap)
    del snap["version"]
    with pytest.raises(ValueError, match=r"no 'version' field"):
        GritIndex.restore(snap)
    with pytest.raises(ValueError, match=r"empty"):
        check_version({"version": np.empty(0, np.int64)}, "version", (1, 2),
                      "snapshot")
    path = tmp_path / "snap.npz"
    port.save(str(path))
    raw = path.read_bytes()
    trunc = tmp_path / "trunc.npz"
    trunc.write_bytes(raw[:len(raw) // 2])
    with pytest.raises(ValueError, match=r"trunc.*npz"):
        load_snapshot(str(trunc))
    other = tmp_path / "other.npz"
    np.savez(str(other), foo=np.arange(3))
    with pytest.raises(ValueError, match=r"no 'version' field"):
        check_version(load_snapshot(str(other)), "version", (1, 2),
                      "snapshot")
    p = tmp_path / "s.npz"
    save_snapshot(str(p), {"version": np.asarray([2], np.int64),
                           "x": np.arange(5.0)})
    back = load_snapshot(str(p))
    assert set(back) == {"version", "x"}
    assert check_version(back, "version", (1, 2), "snapshot") == 2
