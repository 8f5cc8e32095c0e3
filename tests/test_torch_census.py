"""The cap census by the grid tree, the ragged descent, and a 7-D fit.

At d = 7 the offset stencil has 197,067 offsets, so probing it for every
grid below MinPts costs the stencil, not the data.  Where the small grids
times the stencil exceed ``adaptive.PROBE_BUDGET`` the census walks the
grid tree instead (``grid_tree.descend``, the same ragged descent the
device neighbour table runs).  Pinned on the CPU:

* the walk's census equals the stencil's, and the largest candidate
  total of a small grid that the pipeline's own neighbour table gives,
  at d = 2 ... 7; where the stencil is kept it equals the reference's;
* the descent's neighbour sets and offsets equal the host grid tree's at
  d = 6 and 7;
* a 7-D SS-varden fit (``engine="device"`` and ``"grit"``) against the
  float64 brute check, with hundreds of small grids of dozens of
  neighbours, in one attempt;
* the span ``adaptive.census``, the gauge ``adaptive.census.probes``
  (set whether or not the tracer is on), the tier args of
  ``device_dbscan.core`` and the counter ``kernels.dist.<route>``.
"""

import math

import numpy as np
import pytest
import torch

import repro.engine as jengine
import repro_torch.engine.adaptive as tadaptive
from repro_torch import obs
from repro_torch.core import grid_tree
from repro_torch.core.grid_tree import GridTree, device_neighbor_table
from repro_torch.core.grids import build_grids_device, identifiers
from repro_torch.core.validate import check_conformant_brute
from repro_torch.data.seed_spreader import seed_spreader
from repro_torch.engine import cluster, estimate_caps
from repro_torch.kernels import ops

#: eps by d for 3,000 seed-spreader points (MinPts 20): small grids with
#: neighbours at every d
EPS = {2: 1500.0, 3: 1500.0, 4: 1500.0, 5: 1500.0, 6: 2500.0, 7: 2500.0}
MIN_PTS = 20


def spreader(n, d, seed, noise=1e-3):
    return np.rint(seed_spreader(n, d, variant="varden", restarts=10,
                                 c_reset=100, r_vicinity=100.0,
                                 r_shift=50.0 * d, noise_frac=noise,
                                 seed=seed))


def pipeline_cand_max(pts, eps, min_pts):
    """The largest candidate total of a grid below MinPts, as the device
    pipeline counts it: its own occupancy plus its neighbour table's."""
    x = torch.as_tensor(pts, dtype=torch.float32)
    dg = build_grids_device(x, eps, 1 << 14)
    nbr, _, of, ok = device_neighbor_table(dg.ids, dg.num_grids,
                                           frontier_cap=1 << 14,
                                           k_cap=1 << 12, include_self=False)
    assert not bool(of) and not bool(ok)
    counts = dg.counts.to(torch.int64)
    nb = nbr.to(torch.int64)
    total = counts + torch.where(nb >= 0, counts[nb.clamp_min(0)], 0).sum(1)
    live = torch.arange(len(counts)) < dg.num_grids
    small = live & (counts < min_pts) & (counts > 0)
    return int(total[small].max())


@pytest.mark.parametrize("d", [2, 3, 4, 5, 6, 7])
def test_the_walk_census_is_the_stencil_census(d, monkeypatch):
    pts = spreader(3000, d, seed=d)
    eps = EPS[d]
    x = torch.as_tensor(pts)
    monkeypatch.setattr(tadaptive, "PROBE_BUDGET", 1 << 62)
    stencil = tadaptive.device_grid_census(x, eps, MIN_PTS)
    monkeypatch.setattr(tadaptive, "PROBE_BUDGET", 0)
    walk = tadaptive.device_grid_census(x, eps, MIN_PTS)
    host_walk = tadaptive._host_census(pts, eps, MIN_PTS)
    assert stencil.max_nbrs is None and walk.max_nbrs is not None
    assert stencil.small == walk.small > 0
    assert walk.cand_max == stencil.cand_max == host_walk[0]
    assert walk.cand_max >= pipeline_cand_max(pts, eps, MIN_PTS)
    assert stencil.probes == stencil.small * (
        len(grid_tree.offset_stencil(d)[0]))
    ids, _, _ = identifiers(pts, eps)
    uids = np.unique(ids, axis=0)
    indptr, _, _ = GridTree.build(uids).query(uids)
    assert walk.max_nbrs == int(np.diff(indptr).max()) - 1
    assert walk.widest >= walk.max_nbrs + 1
    if d <= 5:
        assert stencil.cand_max == jengine.candidate_census(pts, eps,
                                                            MIN_PTS)


@pytest.mark.parametrize("d", [6, 7])
def test_the_descent_is_the_host_grid_tree(d):
    pts = spreader(3000, d, seed=10 + d)
    ids, _, _ = identifiers(pts, EPS[d])
    uids = np.unique(ids, axis=0)
    rows = torch.as_tensor(uids)
    levels = grid_tree.level_arrays(rows)
    q_of, grid, off, widest, over, entries = grid_tree.descend(levels, rows)
    indptr, hgrid, hoff = GridTree.build(uids).query(uids)
    np.testing.assert_array_equal(np.bincount(q_of.numpy(),
                                              minlength=len(uids)),
                                  np.diff(indptr))
    for g in range(len(uids)):
        sl = slice(int(indptr[g]), int(indptr[g + 1]))
        mine = (q_of == g).numpy()
        assert set(grid.numpy()[mine]) == set(hgrid[sl])
        np.testing.assert_array_equal(off.numpy()[mine], hoff[sl])
    assert not over.any() and entries >= len(hgrid)
    assert int(widest.max()) >= int(np.diff(indptr).max())


def varden7():
    """6,000 7-D SS-varden points at eps 5,000, MinPts 20: 149 of 225
    grids below MinPts, with 49 neighbours each on average."""
    return spreader(6000, 7, seed=7), 5000.0, 20


def test_a_7d_fit_is_conformant_to_the_brute_check():
    pts, eps, min_pts = varden7()
    ids, _, _ = identifiers(pts, eps)
    uids, counts = np.unique(ids, axis=0, return_counts=True)
    indptr, _, _ = GridTree.build(uids).query(uids, include_self=False)
    small = counts < min_pts
    assert small.sum() >= 100 and np.diff(indptr)[small].mean() >= 30
    for engine in ("device", "grit"):
        res = cluster(pts, eps, min_pts, engine=engine, device="cpu")
        got = check_conformant_brute(pts, eps, min_pts, res.labels, res.core,
                                     device="cpu")
        assert got["clusters"] == res.n_clusters > 1
        if engine == "device":
            assert [a["overflow"] for a in res.attempts] == [()]
    probes = obs.registry().snapshot()["adaptive.census.probes"]["value"]
    assert 0 < probes < small.sum() * len(grid_tree.offset_stencil(7)[0])


def test_the_walk_sizes_k_cap_and_the_frontier():
    pts, eps, min_pts = varden7()
    census = tadaptive.device_grid_census(torch.as_tensor(pts), eps, min_pts)
    assert census.max_nbrs is not None
    caps = estimate_caps(pts, eps, min_pts)
    assert caps.k_cap == max(8, math.ceil(census.max_nbrs * 1.25 / 8) * 8)
    assert caps.frontier_cap >= census.widest * 1.25
    assert caps.frontier_cap < 2 * max(32, census.widest * 1.25)
    # below the 3^d - 1 heuristic the stencil route would start from
    assert caps.k_cap < 3 ** 7 - 1


def test_the_census_gauge_is_set_with_the_tracer_off():
    assert obs.get_tracer() is None
    pts, eps, min_pts = varden7()
    obs.gauge("adaptive.census.probes").set(-1)
    estimate_caps(pts, eps, min_pts)
    census = tadaptive.device_grid_census(torch.as_tensor(pts), eps, min_pts)
    assert obs.gauge("adaptive.census.probes").value == census.probes > 0
    assert obs.get_tracer() is None


def test_the_census_and_core_spans_carry_their_args():
    obs.enable(clear=True)
    try:
        pts, eps, min_pts = varden7()
        cluster(pts, eps, min_pts, engine="device-kernels", device="cpu")
        events = obs.get_tracer().snapshot_events()
    finally:
        obs.disable()
    (census,) = [e for e in events if e["name"] == "adaptive.census"]
    assert census["args"]["route"] == "tree"
    assert census["args"]["small"] >= 100
    assert census["args"]["probes"] == \
        obs.gauge("adaptive.census.probes").value
    (core,) = [e for e in events if e["name"] == "device_dbscan.core"]
    widths, grids = core["args"]["tier_widths"], core["args"]["tier_grids"]
    assert len(widths) == len(grids) == 3 and widths == sorted(widths)
    assert sum(grids) >= 100


@pytest.mark.parametrize("d,route", [(1, "packed"), (3, "packed"),
                                     (4, "planes"), (5, "planes"),
                                     (6, "runtime_d"), (7, "runtime_d"),
                                     (8, "runtime_d")])
def test_a_distance_launch_counts_its_route(d, route):
    assert ops.dist_launch_route(d) == route
    c = obs.counter(f"kernels.dist.{route}")
    before, calls = c.value, ops.LAUNCHES["eps_count_batch"]
    ops._count_dist_launch("eps_count_batch", d)
    assert c.value == before + 1
    assert ops.LAUNCHES["eps_count_batch"] == calls + 1
    ops.LAUNCHES["eps_count_batch"] = calls


@pytest.mark.gpu
def test_a_7d_launch_on_the_card_counts_the_runtime_d_route():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator().manual_seed(0)
    a = torch.rand((4, 8, 7), generator=g).cuda()
    b = torch.rand((4, 300, 7), generator=g).cuda()
    c = obs.counter(f"kernels.dist.{ops.dist_launch_route(7)}")
    before = c.value
    got = ops.eps_count_batch(a, b, 0.6)
    want = ops.eps_count_batch_plain(a.cpu(), b.cpu(), 0.6)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert c.value == before + 1
