"""Port device-resident serving vs host serving and vs the JAX package
(twin of ``tests/test_device_serving.py``), with the resident state on
the CPU (``ensure_device_state("cpu")``).

The resident path must be **bit-identical** to host serving: predict
labels and float64 d2, ``labels_arrival`` / ``core_arrival``, the merge
edges and the semantic mutation stats, after every op of the serving
and churn catalogues, with the resident mirror equal to the host arrays
(``mirror_matches``) throughout.  Port equals reference: the host side
of each pair is held to ``repro.index.GritIndex`` on the same fit and
the same ops, so the port's device path equals the reference's host
path, which the reference's own suite pins to its device path.

The float32 distances may differ from the reference's in the last bit,
so only the counters in ``NONSEMANTIC`` may differ between the packages
and between the two planes.
"""

import io
import zlib

import numpy as np
import pytest
import torch

from repro.core.dbscan import grit_dbscan
from repro.index import GritIndex as JIndex
from repro_torch.data.scenarios import (get_churn_scenario,
                                        get_serving_scenario)
from repro_torch.index import GritIndex, device_state

_DEFAULT_GATES = (device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T)
SERVING = ["query-heavy-3d", "drift-2d"]
CHURN = ["churn-split-2d", "ttl-drift-3d"]
NONSEMANTIC = {"dist_evals", "t_total", "t_pack", "t_kernel",
               "band_fallback"}


@pytest.fixture(autouse=True)
def _force_device_stages(monkeypatch):
    """The catalogue is small, so under the default gates every delta
    stage would route to its host twin: pin the gates to 0 so every
    stage runs on the resident tensors (``test_default_gates_differential``
    restores them)."""
    monkeypatch.setattr(device_state, "MIN_FLAT_T", 0)
    monkeypatch.setattr(device_state, "EDGE_MIN_FLAT_T", 0)


def _seed(*key) -> int:
    return zlib.crc32("/".join(map(str, key)).encode())


class Planes:
    """The same fit three times: reference host, port host, port with a
    resident state on the CPU."""

    def __init__(self, pts, eps, min_pts):
        res = grit_dbscan(pts, eps, min_pts)
        self.ref = JIndex.from_fit(pts, eps, min_pts, res.labels,
                                   core=res.core)
        self.host = GritIndex.from_fit(pts, eps, min_pts, res.labels,
                                       core=res.core)
        self.dev = GritIndex.from_fit(pts, eps, min_pts, res.labels,
                                      core=res.core)
        self.dev.ensure_device_state("cpu")

    def op(self, name, arg, where):
        out = [getattr(i, name)(arg) for i in (self.ref, self.host,
                                               self.dev)]
        for s in out[1:]:
            assert set(s) == set(out[0]), where
            for k in set(s) - NONSEMANTIC:
                np.testing.assert_array_equal(s[k], out[0][k],
                                              err_msg=f"{where} {k}")
        self.check(where)
        return out[2]

    def check(self, where):
        r = self.ref
        for idx in (self.host, self.dev):
            np.testing.assert_array_equal(idx.labels_arrival(),
                                          r.labels_arrival(), str(where))
            np.testing.assert_array_equal(idx.core_arrival(),
                                          r.core_arrival(), str(where))
            if r.merge_edges is None:
                assert idx.merge_edges is None, where
            else:
                np.testing.assert_array_equal(idx.merge_edges,
                                              r.merge_edges, str(where))
        mm = self.dev.device_state.mirror_matches(self.dev)
        assert all(mm.values()), (where, mm)

    def predict(self, q, where):
        lr, dr = self.ref.predict(q, mode="host", return_d2=True)
        lh, dh = self.host.predict(q, mode="host", return_d2=True)
        st = {}
        ld, dd = self.dev.predict(q, mode="device", return_d2=True, stats=st)
        for lab, d2 in ((lh, dh), (ld, dd)):
            np.testing.assert_array_equal(lab, lr, str(where))
            np.testing.assert_array_equal(d2, dr, str(where))  # inf too
        assert st["mode"] == "device"
        return st


def _probe_queries(ss, pts, eps, seed):
    """Scenario queries plus exact-eps boundary queries off real points,
    far out-of-bbox queries and likely-empty interior cells."""
    rng = np.random.default_rng(seed)
    d = pts.shape[1]
    base = pts[rng.integers(0, len(pts), 8)]
    axis = np.zeros((8, d))
    axis[:, 0] = eps
    span = pts.max(0) - pts.min(0)
    outside = pts.max(0)[None, :] + span[None, :] * (1.0 + rng.random((8, d)))
    between = (pts.min(0) + pts.max(0))[None, :] / 2 + rng.normal(
        scale=span / 50, size=(8, d))
    return np.concatenate([ss.query_batch(0, 64), base + axis, outside,
                           between])


@pytest.mark.parametrize("name", SERVING)
def test_predict_differential(name):
    ss = get_serving_scenario(name)
    pts = ss.fit_points()
    pl = Planes(pts, ss.base.eps, ss.base.min_pts)
    q = _probe_queries(ss, pts, ss.base.eps, _seed("predict", name))
    st = pl.predict(q, name)
    assert st["chunks"] == 1 and st["candidates"] > 0
    # auto routes through the attached state, whatever the device says
    st2 = {}
    la = pl.dev.predict(q, stats=st2, device="cpu")
    assert st2["mode"] == "device"
    np.testing.assert_array_equal(la, pl.host.predict(q, mode="host"))
    # the two-phase form gives the same answer
    resolve = pl.dev.predict_async(q, return_d2=True)
    ld, dd = resolve()
    np.testing.assert_array_equal(dd, pl.host.predict(q, mode="host",
                                                      return_d2=True)[1])


@pytest.mark.parametrize("name", SERVING)
def test_serving_stream_differential(name):
    ss = get_serving_scenario(name)
    pl = Planes(ss.fit_points(), ss.base.eps, ss.base.min_pts)
    for i, batch in enumerate(ss.insert_batches(0, 3)):
        pl.op("insert", batch, (name, "insert", i))
        pl.predict(ss.query_batch(i, 32), (name, "predict", i))


@pytest.mark.parametrize("name", CHURN)
def test_churn_differential(name):
    sc = get_churn_scenario(name)
    pl = Planes(sc.fit_points(), sc.base.eps, sc.base.min_pts)
    for i, (op, arg) in enumerate(sc.ops(0)):
        pl.op(op, arg, (name, op, i))
    np.testing.assert_array_equal(pl.host.ensure_merge_graph(),
                                  pl.dev.ensure_merge_graph())


def test_default_gates_differential():
    """With the default gates small stages run their host twins; the mix
    stays bit-identical, including the resident core-flag sync after a
    host-twin recompute."""
    device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T = _DEFAULT_GATES
    sc = get_churn_scenario("churn-split-2d")
    pts = sc.fit_points()
    pl = Planes(pts, sc.base.eps, sc.base.min_pts)
    for i, (op, arg) in enumerate(sc.ops(0)):
        pl.op(op, arg, ("gated", op, i))
    pl.predict(pts[:64], "gated")


@pytest.mark.parametrize("gates", ["zero", "default"])
def test_stage_routes_are_counted(gates):
    """``stage_runs`` / ``stage_s`` say which route every resident stage
    took: with the gates at 0 each write-half stage enqueues its flat
    gather and none runs its host twin; under the default gates the
    small catalogue sends every write-half stage to its host twin.
    Device predict always gathers flat."""
    if gates == "default":
        device_state.MIN_FLAT_T, device_state.EDGE_MIN_FLAT_T = _DEFAULT_GATES
    sc = get_churn_scenario("churn-split-2d")
    pl = Planes(sc.fit_points(), sc.base.eps, sc.base.min_pts)
    ds = pl.dev.device_state
    assert all(v == 0 for r in ds.stage_runs.values() for v in r.values())
    for i, (op, arg) in enumerate(sc.ops(0)):
        pl.op(op, arg, ("routes", gates, op, i))
    for i in range(3):
        pl.predict(sc.fit_points()[i * 16:(i + 1) * 16], ("routes", i))
    runs = ds.stage_runs
    assert runs["predict"] == {"flat": 3, "host_twin": 0}
    write = ("cores", "edges", "border")
    if gates == "zero":
        assert all(runs[s]["flat"] > 0 and runs[s]["host_twin"] == 0
                   for s in write), runs
    else:
        assert all(runs[s]["flat"] == 0 and runs[s]["host_twin"] > 0
                   for s in write), runs
    for s, r in runs.items():
        for route, k in r.items():
            assert (ds.stage_s[s][route] > 0) == (k > 0), (s, route)


def test_delete_split_differential():
    rng = np.random.default_rng(_seed("split"))
    left = rng.normal(size=(60, 2), scale=0.3)
    right = rng.normal(size=(60, 2), scale=0.3) + [6.0, 0.0]
    bridge = np.stack([np.linspace(0.8, 5.2, 24), np.zeros(24)], axis=1)
    bridge += rng.normal(scale=0.02, size=bridge.shape)
    pl = Planes(np.concatenate([left, right, bridge]), 0.5, 4)
    assert len(np.unique(pl.host.labels[pl.host.labels >= 0])) == 1
    pl.op("delete", np.arange(120, 144), "split")
    lab = pl.dev.labels_arrival()
    assert len(np.unique(lab[lab >= 0])) == 2


def test_interleaved_stress_and_snapshot_roundtrip():
    """Seeded random insert / delete / predict stream through the
    in-place flag updates, the mirror pinned after every op; then the
    device index snapshots exactly the host state and a restored index
    re-attaches a resident state and serves the same answers."""
    rng = np.random.default_rng(_seed("stress"))
    n, eps = 160, 0.35
    pts = np.concatenate([rng.normal(size=(n // 2, 2), scale=0.4),
                          rng.normal(size=(n // 2, 2), scale=0.4)
                          + [3.0, 1.0]])
    pl = Planes(pts, eps, 4)
    lo, hi = pts.min(0), pts.max(0)
    for i in range(25):
        op = rng.choice(["insert", "delete", "predict"], p=[0.4, 0.3, 0.3])
        if op == "insert":
            b = rng.uniform(lo - 2 * eps, hi + 2 * eps,
                            size=(int(rng.integers(3, 24)), 2))
            pl.op("insert", b, ("stress", i))
        elif op == "delete":
            live = pl.host.arrival_live()
            ids = rng.choice(live, min(len(live), int(rng.integers(1, 16))),
                             replace=False)
            pl.op("delete", np.concatenate([ids, [10 ** 9]]), ("stress", i))
        else:
            q = rng.uniform(lo - eps, hi + eps,
                            size=(int(rng.integers(4, 48)), 2))
            pl.predict(q, ("stress", i))
    ds = pl.dev.device_state
    assert ds.in_place > 0 and ds.uploads > 0
    sh, sd = pl.host.snapshot(), pl.dev.snapshot()
    assert set(sh) == set(sd)
    for k in sh:
        np.testing.assert_array_equal(sh[k], sd[k], err_msg=k)
    buf = io.BytesIO()
    pl.dev.save(buf)
    buf.seek(0)
    back = GritIndex.load(buf)
    assert back.device_state is None              # the mirror is not shipped
    q = rng.uniform(-1, 4, size=(64, 2))
    want = pl.ref.predict(q, mode="host")
    np.testing.assert_array_equal(back.predict(q, mode="host"), want)
    back.ensure_device_state("cpu")
    np.testing.assert_array_equal(back.predict(q, mode="device"), want)


def test_compaction_refreshes_mirror():
    rng = np.random.default_rng(_seed("compact"))
    pl = Planes(rng.normal(size=(200, 2)), 0.4, 4)
    for idx in (pl.ref, pl.host, pl.dev):
        idx.compact_threshold = 0.15
    st = pl.op("delete", np.arange(0, 80), "compact")
    assert st["compacted"] and pl.dev.n == pl.dev.n_live
    pl.predict(rng.normal(size=(32, 2)), "compact")


def test_resident_state_device_rule_and_drop():
    """``ensure_device_state()`` defaults to the card and raises without
    one; an attached state is kept whatever ``device`` says; dropping it
    sends serving back to host."""
    ss = get_serving_scenario("drift-2d")
    pts = ss.fit_points()
    pl = Planes(pts, ss.base.eps, ss.base.min_pts)
    ds = pl.dev.device_state
    assert ds.device == torch.device("cpu")
    assert ds.points_res.dtype == torch.float32
    assert pl.dev.ensure_device_state() is ds
    fresh = GritIndex.restore(pl.host.snapshot())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fresh.ensure_device_state()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fresh.predict(pts[:4], mode="device")
    # the band thresholds bracket eps^2 and follow the reference formula
    band, lo2, hi2 = ds.thresholds(pl.dev)
    eps2 = ss.base.eps ** 2
    assert lo2 < eps2 < hi2 and 0 < band < 1e-3
    pl.dev.drop_device_state()
    st = {}
    q = ss.query_batch(0, 16)
    out = pl.dev.predict(q, stats=st, device="cpu")
    assert st["mode"] == "host"
    np.testing.assert_array_equal(out, pl.ref.predict(q, mode="host"))
