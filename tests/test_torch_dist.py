"""The port's distributed plane (``repro_torch.dist``) against the JAX
package's (``repro.dist``), on the CPU.

* Twins of ``tests/test_dist_units.py``: slab cuts, pack / unpack,
  ``halo_bound`` and ``halo_buffer`` (cap > n and the overflow flag
  included), the same numpy inputs through both packages with equal
  outputs.  The reference's jit step cache has no twin: an eager step
  has nothing to compile, so there is nothing to cache.
* ``shared_point_edges`` and ``global_component_map`` against the
  reference's (its map pointer-jumps the concatenated edge lists with
  ``label_propagation``, which is what its ``all_gather`` feeds).
* ``estimate_shard_caps`` equal to the reference's.
* ``distributed_fit`` with one shard equal, raw, to the reference on a
  1-device mesh in this process; with four shards equal, raw, to the
  reference on a 4-device host mesh, which needs a fresh process (the
  device count is read when JAX starts).
* The ``distributed`` engine conformant to ``brute_dbscan``; the traced
  (staged) and untraced fits equal; the adaptive loop growing the halo
  cap; the device rule.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dist as jdist
from repro.core.labels import label_propagation as jlabel_propagation
from repro.dist import reconcile as jreconcile
from repro.dist.sharding import unshard_by_perm as junshard
from repro.engine import estimate_shard_caps as jestimate_shard_caps
from repro_torch import convert, obs
from repro_torch import dist as tdist
from repro_torch.core import labels as tlabels
from repro_torch.core.dbscan import brute_dbscan
from repro_torch.core.device_dbscan import PAD_COORD
from repro_torch.core.sync import STAGE_ORDER
from repro_torch.core.validate import assert_labels_conformant
from repro_torch.data.scenarios import dist_serving_scenarios, get_scenario
from repro_torch.dist import reconcile as treconcile
from repro_torch.dist.sharding import unshard_by_perm as tunshard
from repro_torch.engine import cluster, estimate_shard_caps

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH_SCENARIOS = ("cross-slab-2d", "cross-slab-3d", "blobs-2d")
FIELDS = ("labels", "core", "point_grid", "shard_of", "cut_coords")


# --------------------------------------------------------------------------
# slab cuts + pack/unpack (twins of tests/test_dist_units.py)
# --------------------------------------------------------------------------

def _loop_cuts(points, eps, n_shards):
    """The original per-shard loop (pre-vectorization), as the oracle."""
    pts = np.asarray(points, np.float64)
    n, d = pts.shape
    side = eps / np.sqrt(d)
    key = np.floor((pts[:, 0] - pts[:, 0].min()) / side).astype(np.int64)
    order = np.argsort(key, kind="stable")
    cuts = [0]
    for s in range(1, n_shards):
        tgt = s * n // n_shards
        while tgt < n and tgt > cuts[-1] and \
                key[order[tgt]] == key[order[tgt - 1]]:
            tgt += 1
        cuts.append(min(tgt, n))
    return order, cuts[1:]


@pytest.mark.parametrize("n_shards", [2, 3, 4, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_slab_cuts_equal_reference_and_loop(n_shards, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1000, size=(257, 3))
    eps = 40.0
    got = tdist.slab_cuts(pts, eps, n_shards)
    for a, b in zip(jdist.slab_cuts(pts, eps, n_shards), got):
        np.testing.assert_array_equal(a, b)
    order, cut_idx, cut_coords = got
    ref_order, ref_cuts = _loop_cuts(pts, eps, n_shards)
    np.testing.assert_array_equal(order, ref_order)
    np.testing.assert_array_equal(cut_idx, ref_cuts)
    finite = cut_coords[np.isfinite(cut_coords)]
    owner = tdist.owner_of_slab(pts[:, 0], finite)
    np.testing.assert_array_equal(
        owner, jdist.owner_of_slab(pts[:, 0], finite))
    starts = np.concatenate([[0], cut_idx])
    ends = np.concatenate([cut_idx, [len(pts)]])
    ref_owner = np.empty(len(pts), np.int64)
    for s in range(n_shards):
        ref_owner[order[starts[s]:ends[s]]] = s
    np.testing.assert_array_equal(owner, ref_owner)


def test_slab_cuts_duplicate_keys_stay_on_grid_lines():
    pts = np.zeros((60, 2))
    pts[:30, 0] = 10.0
    pts[30:, 0] = 500.0
    _, cut_idx, _ = tdist.slab_cuts(pts, 20.0, 4)
    assert set(cut_idx.tolist()) <= {0, 30, 60}
    np.testing.assert_array_equal(cut_idx,
                                  jdist.slab_cuts(pts, 20.0, 4)[1])


def test_shard_points_roundtrip_equal_reference():
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 500, size=(123, 2))
    sh, valid, perm = tdist.shard_points_by_slab(pts, 25.0, 4)
    for a, b in zip(jdist.shard_points_by_slab(pts, 25.0, 4),
                    (sh, valid, perm)):
        np.testing.assert_array_equal(a, b)
    assert sh.shape[0] == 4 and valid.shape == sh.shape[:2]
    got = tunshard(sh.astype(np.float64), perm, len(pts))
    np.testing.assert_array_equal(
        got, junshard(sh.astype(np.float64), perm, len(pts)))
    np.testing.assert_allclose(got, pts, rtol=1e-6)
    assert valid.sum() == len(pts)
    with pytest.raises(ValueError, match="pad_to"):
        tdist.shard_points_by_slab(pts, 25.0, 4, pad_to=2)
    sh2, valid2, _ = tdist.shard_points_by_slab(pts, 25.0, 4, pad_to=64)
    assert sh2.shape[1] == 64 and valid2.sum() == len(pts)
    assert (sh2[~valid2] == np.float32(PAD_COORD)).all()


def test_halo_bound_is_window_maximum():
    pts = np.array([[0.0], [1.0], [1.5], [10.0], [10.4], [10.8], [30.0]])
    assert tdist.halo_bound(pts, 1.0) == 3 == jdist.halo_bound(pts, 1.0)
    assert tdist.halo_bound(pts, 5.0) == 5 == jdist.halo_bound(pts, 5.0)


# --------------------------------------------------------------------------
# halo buffer
# --------------------------------------------------------------------------

def _halo_both(n, cap, side="lo", eps=1.0, valid_every=1, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.sort(rng.uniform(0, 10, size=(n, 1)), axis=0)
    pts = np.concatenate([pts, np.full((n, 1), 5.0)], axis=1)
    pts = pts.astype(np.float32)
    valid = np.arange(n) % valid_every == 0
    ref = jdist.halo_buffer(jnp.asarray(pts), jnp.asarray(valid), eps,
                            side, cap)
    got = tdist.halo_buffer(torch.from_numpy(pts), torch.from_numpy(valid),
                            eps, side, cap)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x0 = pts[:, 0].astype(np.float32)
    xv = x0[valid]
    near = valid & ((x0 <= xv.min() + np.float32(2 * eps)) if side == "lo"
                    else (x0 >= xv.max() - np.float32(2 * eps)))
    buf, idx, ovf = (t.numpy() for t in got)
    return buf, idx, bool(ovf), np.flatnonzero(near)


@pytest.mark.parametrize("side", ["lo", "hi"])
@pytest.mark.parametrize("valid_every", [1, 3])
def test_halo_buffer_selects_boundary_points(side, valid_every):
    buf, idx, ovf, want = _halo_both(32, 16, side, valid_every=valid_every)
    np.testing.assert_array_equal(np.sort(idx[idx >= 0]), want)
    assert not ovf
    assert buf.dtype == np.float32 and idx.dtype == np.int32


def test_halo_buffer_cap_exceeding_shard_size():
    buf, idx, ovf, want = _halo_both(n=12, cap=64)
    assert buf.shape == (64, 2) and idx.shape == (64,)
    np.testing.assert_array_equal(np.sort(idx[idx >= 0]), want)
    assert not ovf
    assert (idx[len(want):] == -1).all()
    assert (buf[len(want):] >= PAD_COORD / 2).all()


def test_halo_buffer_overflow_flag():
    buf, idx, ovf, want = _halo_both(n=32, cap=2)
    assert len(want) > 2
    assert ovf
    assert (idx >= 0).sum() == 2


def test_halo_buffer_one_or_no_valid_row():
    """One valid row selects itself; no valid row selects nothing (the
    +-inf extremes), overflow never fires -- on both packages."""
    buf, idx, ovf, want = _halo_both(n=8, cap=4, valid_every=100)
    np.testing.assert_array_equal(idx[idx >= 0], want)
    assert list(want) == [0] and not ovf
    pts = np.zeros((8, 2), np.float32)
    none = np.zeros(8, bool)
    for side in ("lo", "hi"):
        ref = jdist.halo_buffer(jnp.asarray(pts), jnp.asarray(none), 1.0,
                                side, 4)
        got = tdist.halo_buffer(torch.from_numpy(pts),
                                torch.from_numpy(none), 1.0, side, 4)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert (got[1] == -1).all() and not bool(got[2])


@pytest.mark.parametrize("name", MESH_SCENARIOS)
def test_halo_census_helpers_equal_reference(name):
    sc = get_scenario(name)
    pts = sc.points()
    for n_shards in (2, 4):
        assert tdist.boundary_census(pts, sc.eps, n_shards) == \
            jdist.boundary_census(pts, sc.eps, n_shards)
        assert tdist.census_halo_cap(pts, sc.eps, n_shards) == \
            jdist.census_halo_cap(pts, sc.eps, n_shards)
        sh, valid, _ = tdist.shard_points_by_slab(pts, sc.eps, n_shards)
        from repro.dist.halo import halo_census as jcensus
        from repro_torch.dist.halo import halo_census as tcensus
        assert tcensus(sh, valid, sc.eps, 64) == \
            jcensus(sh, valid, sc.eps, 64)


# --------------------------------------------------------------------------
# reconciliation
# --------------------------------------------------------------------------

def _edge_case(seed, H=24, n=40, L=16):
    rng = np.random.default_rng(seed)
    own_labels = rng.integers(-1, L, n).astype(np.int32)
    own_core = rng.random(n) < 0.6
    local_idx = np.where(rng.random(H) < 0.8, rng.integers(0, n, H),
                         -1).astype(np.int32)
    remote = rng.integers(-1, L, H).astype(np.int32)
    return own_labels, own_core, local_idx, remote


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_point_edges_equal_reference(seed):
    L = 16
    args = _edge_case(seed, L=L)
    for me, other in ((0, 1), (2, 1), (3, 3)):
        ref = jreconcile.shared_point_edges(
            *(jnp.asarray(a) for a in args), me, other, L)
        got = treconcile.shared_point_edges(
            *(torch.from_numpy(a) for a in args), me, other, L)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert got[1].any() and not got[1].all()


def test_global_component_map_equal_reference():
    """Four shards' edge lists: the port concatenates them in shard
    order; the reference's map is ``label_propagation`` over what its
    ``all_gather`` concatenates.  The port's map is the union-find's
    components of the concatenated edges.  The reference's stops at its
    round cap (log2(64) + 2) three nodes short of them here, which the
    port's ``label_propagation`` (run to its fixpoint) does not."""
    L, n_shards = 16, 4
    edges, oks = [], []
    for s in range(n_shards):
        args = _edge_case(10 + s, L=L)
        e, ok = treconcile.shared_point_edges(
            *(torch.from_numpy(a) for a in args), s,
            min(s + 1, n_shards - 1), L)
        edges.append(e)
        oks.append(ok)
    got = treconcile.global_component_map(edges, oks, n_shards, L)
    all_e = np.concatenate([e.numpy() for e in edges])
    all_ok = np.concatenate([o.numpy() for o in oks])
    ref = np.asarray(jlabel_propagation(n_shards * L,
                                        jnp.maximum(jnp.asarray(all_e), 0),
                                        jnp.asarray(all_ok),
                                        jnp.ones((n_shards * L,), bool)))
    uf = tlabels.UnionFind(n_shards * L)
    for (u, v), ok in zip(np.maximum(all_e.reshape(-1, 2), 0),
                          all_ok.reshape(-1)):
        if ok:
            uf.union(int(u), int(v))
    roots = uf.labels()
    want = np.array([np.flatnonzero(roots == roots[i]).min()
                     for i in range(n_shards * L)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (ref != want).sum() == 3
    assert len(np.unique(got.numpy())) < n_shards * L


# --------------------------------------------------------------------------
# caps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(s.name for s in
                                         dist_serving_scenarios()))
def test_estimate_shard_caps_equal_reference(name):
    ss = {s.name: s for s in dist_serving_scenarios()}[name]
    pts = ss.fit_points()
    for n_shards in (1, 2, 4):
        for kw in ({}, {"use_kernels": True, "margin": 2.0}):
            got = estimate_shard_caps(pts, ss.base.eps, ss.base.min_pts,
                                      n_shards, **kw)
            ref = jestimate_shard_caps(pts, ss.base.eps, ss.base.min_pts,
                                       n_shards, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)


# --------------------------------------------------------------------------
# the fit against the reference's
# --------------------------------------------------------------------------

def _caps_pair(pts, eps, min_pts, n_shards):
    """The reference's caps and their port twin."""
    jcaps = jdist.ClusterCaps(
        grit=jestimate_shard_caps(pts, eps, min_pts, n_shards),
        halo_cap=jdist.census_halo_cap(pts, eps, n_shards))
    tcaps = tdist.ClusterCaps(
        grit=convert.caps_from_dict(dataclasses.asdict(jcaps.grit)),
        halo_cap=jcaps.halo_cap)
    return jcaps, tcaps


@pytest.mark.parametrize("name", MESH_SCENARIOS)
def test_one_shard_fit_equals_reference_raw(name):
    import jax
    sc = get_scenario(name)
    pts = sc.points()
    jcaps, tcaps = _caps_pair(pts, sc.eps, sc.min_pts, 1)
    mesh = jax.make_mesh((1,), ("shard",))
    ref = jdist.distributed_fit(pts, sc.eps, sc.min_pts, mesh, caps=jcaps)
    got = tdist.distributed_fit(pts, sc.eps, sc.min_pts, caps=tcaps,
                                n_shards=1, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f)
        assert getattr(ref, f).dtype == getattr(got, f).dtype, f
    assert ref.report.overflowing() == got.report.overflowing() == ()


_MESH_SNIPPET = """
import sys
import numpy as np, jax
from repro.data.scenarios import get_scenario
from repro.dist import ClusterCaps, census_halo_cap, distributed_fit
from repro.engine import estimate_shard_caps

assert jax.device_count() == 4, jax.device_count()
mesh = jax.make_mesh((4,), ("shard",))
out = {}
for name in sys.argv[2].split(","):
    sc = get_scenario(name)
    pts = sc.points()
    caps = ClusterCaps(grit=estimate_shard_caps(pts, sc.eps, sc.min_pts, 4),
                       halo_cap=census_halo_cap(pts, sc.eps, 4))
    r = distributed_fit(pts, sc.eps, sc.min_pts, mesh, caps=caps)
    for f in ("labels", "core", "point_grid", "shard_of", "cut_coords"):
        out[name + "." + f] = np.asarray(getattr(r, f))
    out[name + ".report"] = np.asarray(r.report.as_vector())
np.savez(sys.argv[1], **out)
"""


def test_four_shard_fit_equals_reference_on_a_4_device_mesh(tmp_path):
    """The port's ``distributed_fit(n_shards=4, device="cpu")`` equals,
    raw, the reference's on a 4-device host mesh (a fresh process with
    ``--xla_force_host_platform_device_count=4``): labels, core flags,
    grid provenance, owning shards, cuts and the overflow report, on
    three scenarios."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_MESH_SNIPPET), str(out),
         ",".join(MESH_SCENARIOS)],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    for name in MESH_SCENARIOS:
        sc = get_scenario(name)
        pts = sc.points()
        _, tcaps = _caps_pair(pts, sc.eps, sc.min_pts, 4)
        got = tdist.distributed_fit(pts, sc.eps, sc.min_pts, caps=tcaps,
                                    n_shards=4, device="cpu")
        for f in FIELDS:
            np.testing.assert_array_equal(ref[f"{name}.{f}"],
                                          getattr(got, f),
                                          err_msg=f"{name}: {f}")
        np.testing.assert_array_equal(ref[f"{name}.report"],
                                      got.report.as_vector().numpy())
        assert len(np.unique(got.shard_of)) == 4
        # the snake crosses every cut: one cluster over four shards
        if name.startswith("cross-slab"):
            assert len(set(got.labels[got.core].tolist())) == 1


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

ENGINE_CASES = [("cross-slab-2d", 4), ("cross-slab-3d", 3),
                ("blobs-3d", 4), ("moons-2d", 2), ("duplicates-2d", 4),
                ("uniform-dense-2d", 3), ("all-noise-3d", 2),
                ("simden-5d", 4)]


@pytest.mark.parametrize("name,n_shards", ENGINE_CASES)
def test_distributed_engine_conformant_to_brute(name, n_shards):
    sc = get_scenario(name)
    pts = sc.points()
    res = cluster(pts, sc.eps, sc.min_pts, engine="distributed",
                  n_shards=n_shards, device="cpu")
    ref = brute_dbscan(pts, sc.eps, sc.min_pts)
    assert_labels_conformant(pts, sc.eps, sc.min_pts, ref, res.labels)
    assert res.engine == "distributed" and res.overflow == ()
    assert res.stats["n_shards"] == n_shards
    assert res.stats["devices"] == ["cpu"] * n_shards
    assert res.stats["use_kernels"] is False


def test_engine_kernel_plane_equals_plain_plane():
    """``use_kernels=True`` on CPU shards runs the kernels' plain
    versions: the same labels, core flags and caps trail as the plain
    plane."""
    sc = get_scenario("cross-slab-3d")
    pts = sc.points()
    runs = [cluster(pts, sc.eps, sc.min_pts, engine="distributed",
                    n_shards=4, device="cpu", use_kernels=uk)
            for uk in (False, True)]
    np.testing.assert_array_equal(runs[0].labels, runs[1].labels)
    np.testing.assert_array_equal(runs[0].core, runs[1].core)
    assert runs[1].stats["use_kernels"] is True


def test_engine_grows_halo_cap_from_a_tiny_start():
    """A halo cap below the boundary census overflows; the adaptive
    loop grows it (measured from the raw points) until the fit is
    exact, as the reference's does."""
    sc = get_scenario("cross-slab-2d")
    pts = sc.points()
    caps = tdist.ClusterCaps(
        grit=estimate_shard_caps(pts, sc.eps, sc.min_pts, 4), halo_cap=2)
    res = cluster(pts, sc.eps, sc.min_pts, engine="distributed",
                  n_shards=4, device="cpu", caps=caps)
    assert "halo" in res.attempts[0]["overflow"]
    assert res.attempts[-1]["overflow"] == ()
    assert res.attempts[-1]["caps"]["halo_cap"] > 2
    ref = brute_dbscan(pts, sc.eps, sc.min_pts)
    assert_labels_conformant(pts, sc.eps, sc.min_pts, ref, res.labels)


def test_devices_list_equals_shorthand_and_legacy_wrapper():
    sc = get_scenario("cross-slab-2d")
    pts = sc.points()
    a = tdist.distributed_fit(pts, sc.eps, sc.min_pts, ["cpu"] * 3)
    b = tdist.distributed_fit(pts, sc.eps, sc.min_pts, n_shards=3,
                              device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    labels, report = tdist.distributed_dbscan(pts, sc.eps, sc.min_pts,
                                              n_shards=3, device="cpu")
    np.testing.assert_array_equal(labels, a.labels)
    assert not report
    with pytest.raises(ValueError, match="n_shards=2 but 3 devices"):
        tdist.shard_devices(["cpu"] * 3, n_shards=2)
    with pytest.raises(ValueError, match="n_shards must be"):
        tdist.shard_devices(n_shards=0, device="cpu")
    assert tdist.shard_devices(device="cpu") == [torch.device("cpu")]


def test_traced_fit_equals_untraced_and_records_the_stages():
    sc = get_scenario("cross-slab-3d")
    pts = sc.points()
    plain = tdist.distributed_fit(pts, sc.eps, sc.min_pts, n_shards=4,
                                  device="cpu", traced=False)
    was = obs.enabled()
    t = obs.enable(clear=True)
    try:
        staged = tdist.distributed_fit(pts, sc.eps, sc.min_pts, n_shards=4,
                                       device="cpu", traced=True)
        names = {e["name"] for e in t.snapshot_events()}
    finally:
        if not was:
            obs.disable()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(plain, f), getattr(staged, f))
    # each shard's pipeline records its stage spans too
    stages = {f"device_dbscan.{s}" for s in STAGE_ORDER}
    assert {"dist.fit", "dist.fit.pack", "dist.fit.transfer",
            "dist.fit.halo_exchange", "dist.fit.local_cluster",
            "dist.fit.reconcile", "dist.fit.unpack"} | stages == names


def test_cluster_step_chains_the_stages_and_unpack_reads_are_counted():
    """``make_cluster_step`` gives the fit's per-shard outputs; a fit
    counts, besides the step's own reads, one for the overflow report
    and one per shard for each of labels, core flags and grid rows."""
    from repro_torch.core import sync
    from repro_torch.dist.sharding import pack_slabs
    sc = get_scenario("cross-slab-2d")
    pts = sc.points()
    caps = tdist.ClusterCaps(halo_cap=tdist.census_halo_cap(pts, sc.eps, 3))
    sync.READS["count"] = 0
    res = tdist.distributed_fit(pts, sc.eps, sc.min_pts, caps=caps,
                                n_shards=3, device="cpu", traced=False)
    fit_reads = sync.READS["count"]
    order, cut_idx, _ = tdist.slab_cuts(pts, sc.eps, 3)
    pts_sh, valid_sh, perm = pack_slabs(pts, order, cut_idx)
    step = tdist.make_cluster_step([torch.device("cpu")] * 3, sc.eps,
                                   sc.min_pts, caps)
    sync.READS["count"] = 0
    labels, core, grid, report = step(
        [torch.from_numpy(p) for p in pts_sh],
        [torch.from_numpy(v) for v in valid_sh])
    assert fit_reads == sync.READS["count"] + 1 + 3 * 3
    assert not report
    for got, want in ((labels, res.labels), (core, res.core),
                      (grid, res.point_grid)):
        np.testing.assert_array_equal(
            tunshard(np.stack([t.numpy() for t in got]), perm, len(pts)),
            want)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    from repro_torch.engine import resolve_auto
    from repro_torch.index import fit_sharded
    sc = get_scenario("cross-slab-2d")
    pts = sc.points()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.distributed_fit(pts, sc.eps, sc.min_pts, n_shards=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cluster(pts, sc.eps, sc.min_pts, engine="distributed")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit_sharded(pts, sc.eps, sc.min_pts, engine="distributed")
    # several cards visible: "auto" picks the distributed engine, one
    # shard per card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_auto() == "distributed"
    assert resolve_auto("cuda:0") == "device-kernels"
    assert tdist.shard_devices() == [torch.device("cuda", i)
                                     for i in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_auto() == "device-kernels"
