"""Port device pipeline vs the JAX package: ``device_dbscan``'s six
outputs (labels, core, point_grid, num_clusters, overflow report,
dispatch_tiers) equal to ``repro.core.device_dbscan.device_dbscan`` for
both dispatch modes and both distance planes, on plain and padded
input; tiny caps raise the same overflow flags; the candidate stage fed
with the reference's tables gives the reference's candidates."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core import device_dbscan as jdev
from repro.core.grid_tree import device_neighbor_table as jtable
from repro.core.grids import build_grids_device as jbuild
from repro.engine import estimate_caps as jestimate
from repro_torch import convert
from repro_torch.core import device_dbscan as tdev
from repro_torch.core.dbscan import brute_dbscan
from repro_torch.core.grids import DeviceGrids
from repro_torch.core.validate import assert_labels_conformant
from repro_torch.data.scenarios import get_scenario

NAMES = ["blobs-3d", "cross-slab-2d", "duplicates-2d", "grid-boundary-2d",
         "simden-5d"]
MODES = [(True, True), (True, False), (False, True), (False, False)]
OUTPUTS = ("labels", "core", "point_grid", "num_clusters", "dispatch_tiers")

TINY = dict(grid_cap=8, frontier_cap=8, k_cap=8, c_cap=16, m_cap=8,
            pair_cap=16, grid_block=8, pair_block=8, merge_iters=20)


def _padded(name):
    """The scenario padded to a 128 bucket with masked rows, as the
    engines feed the pipeline."""
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    n = len(pts)
    n_pad = (n + 127) // 128 * 128
    padded = np.zeros((n_pad, sc.d), np.float32)
    padded[:n] = pts
    return sc, padded, np.arange(n_pad) < n


def _both(sc, pts, valid, caps_kw):
    ref = jdev.device_dbscan(jnp.asarray(pts), sc.eps, sc.min_pts,
                             jdev.GritCaps(**caps_kw),
                             point_valid=None if valid is None
                             else jnp.asarray(valid))
    got = tdev.device_dbscan(torch.as_tensor(pts), sc.eps, sc.min_pts,
                             convert.caps_from_dict(caps_kw),
                             point_valid=None if valid is None
                             else torch.as_tensor(valid))
    return ref, got


def _assert_results_equal(ref, got):
    out = convert.result_to_numpy(got)
    for f in OUTPUTS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), out[f],
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.report.as_vector()),
                                  out["report"], err_msg="report")
    assert bool(ref.overflow) == bool(out["overflow"])
    assert jax.device_get(ref.report).overflowing() == \
        got.report.overflowing()


@pytest.fixture(scope="module")
def brute_labels():
    out = {}
    for name in NAMES:
        sc = get_scenario(name)
        out[name] = brute_dbscan(sc.points(), sc.eps, sc.min_pts)
    return out


@pytest.mark.parametrize("packed,use_kernels", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_device_dbscan_outputs_equal(name, packed, use_kernels, brute_labels):
    sc, padded, valid = _padded(name)
    caps = dataclasses.asdict(jestimate(
        padded, sc.eps, sc.min_pts, point_valid=valid))
    caps.update(packed=packed, use_kernels=use_kernels)
    ref, got = _both(sc, padded, valid, caps)
    _assert_results_equal(ref, got)
    assert got.report.overflowing() == ()
    assert got.labels.dtype == torch.int32 and got.core.dtype == torch.bool
    n = sc.n
    assert (got.labels[n:] == -1).all() and not got.core[n:].any()
    assert_labels_conformant(sc.points(), sc.eps, sc.min_pts,
                             brute_labels[name], got.labels[:n].numpy())
    tiers = got.dispatch_tiers.numpy()
    assert (tiers[3] == caps["grid_cap"]) if not packed else (tiers[3] == 0)


@pytest.mark.parametrize("name", ["blobs-3d", "duplicates-2d"])
def test_device_dbscan_equal_without_point_valid(name):
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    caps = dataclasses.asdict(jestimate(pts, sc.eps, sc.min_pts))
    ref, got = _both(sc, pts, None, caps)
    _assert_results_equal(ref, got)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", ["blobs-2d", "duplicates-2d"])
def test_tiny_caps_raise_the_same_overflow_flags(name, use_kernels):
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    ref, got = _both(sc, pts, None, dict(TINY, use_kernels=use_kernels))
    want = jax.device_get(ref.report).overflowing()
    assert got.report.overflowing() == want
    assert "grid" in want and "core_set" in want
    assert bool(got.overflow) and bool(got.report)
    np.testing.assert_array_equal(np.asarray(ref.point_grid),
                                  got.point_grid.numpy())


@pytest.mark.parametrize("cap,flag", [("k_cap", "neighbors"),
                                      ("c_cap", "candidates"),
                                      ("m_cap", "core_set"),
                                      ("pair_cap", "pairs"),
                                      ("frontier_cap", "frontier")])
def test_each_cap_overflows_alone_like_the_reference(cap, flag):
    """One cap too small, the others ample: exactly the reference's
    flags fire (flags come from totals, never from what was dispatched)."""
    sc = get_scenario("blobs-2d")
    pts = sc.points().astype(np.float32)
    caps = dataclasses.asdict(jestimate(pts, sc.eps, sc.min_pts))
    caps[cap] = {"k_cap": 8, "c_cap": 8, "m_cap": 8, "pair_cap": 16,
                 "frontier_cap": 2}[cap]
    if cap == "pair_cap":
        caps["pair_block"] = 16
    ref, got = _both(sc, pts, None, caps)
    want = jax.device_get(ref.report).overflowing()
    assert flag in want
    assert got.report.overflowing() == want
    np.testing.assert_array_equal(np.asarray(ref.dispatch_tiers),
                                  got.dispatch_tiers.numpy())


@pytest.mark.parametrize("name", ["blobs-3d", "grid-boundary-2d"])
def test_candidate_stage_on_reference_tables(name):
    """Stage k of the port fed with the reference's stage k-1: the
    reference's grid and neighbor tables in, its candidate lists out."""
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    caps = jestimate(pts, sc.eps, sc.min_pts)
    ref_dg = jbuild(jnp.asarray(pts), sc.eps, caps.grid_cap)
    ref_nbr, ref_off, _, _ = jtable(ref_dg.ids, ref_dg.num_grids,
                                    frontier_cap=caps.frontier_cap,
                                    k_cap=caps.k_cap, include_self=False)
    ng = int(ref_dg.num_grids)
    gsel = np.arange(ng, dtype=np.int32)
    want = jdev._candidates_for_grids(ref_dg, ref_nbr, jnp.asarray(gsel),
                                      caps.c_cap)
    dg = convert.device_grids_from_numpy(
        **{f: np.asarray(getattr(ref_dg, f)) for f in DeviceGrids.FIELDS})
    nbr, _ = convert.neighbor_table_from_numpy(ref_nbr, ref_off)
    got = tdev._candidates_for_grids(dg, nbr.to(torch.int64),
                                     torch.as_tensor(gsel).to(torch.int64),
                                     caps.c_cap)
    for w, g, what in zip(want, got, ("idx", "grid", "valid", "total")):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=what)


def test_chunk_budgets_are_not_part_of_the_result(monkeypatch):
    sc, padded, valid = _padded("blobs-3d")
    caps = convert.caps_from_dict(dataclasses.asdict(jestimate(
        padded, sc.eps, sc.min_pts, point_valid=valid)))
    args = (torch.as_tensor(padded), sc.eps, sc.min_pts)
    whole = {uk: tdev.device_dbscan(*args, dataclasses.replace(
        caps, use_kernels=uk), point_valid=torch.as_tensor(valid))
        for uk in (False, True)}
    for name in ("SWEEP_ELEMS", "PLAIN_ELEMS", "MERGE_ELEMS"):
        monkeypatch.setattr(tdev, name, 1)          # one row per chunk
    for uk in (False, True):
        parts = tdev.device_dbscan(*args, dataclasses.replace(
            caps, use_kernels=uk), point_valid=torch.as_tensor(valid))
        a, b = convert.result_to_numpy(whole[uk]), \
            convert.result_to_numpy(parts)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_caps_and_report_contracts():
    with pytest.raises(ValueError, match="grid_block"):
        tdev.GritCaps(grid_cap=100, grid_block=64)
    with pytest.raises(ValueError, match="pair_block"):
        tdev.GritCaps(pair_cap=100, pair_block=64)
    for d in (1, 2, 3, 5):
        assert dataclasses.asdict(tdev.GritCaps.for_dim(d)) == \
            dataclasses.asdict(jdev.GritCaps.for_dim(d))
    assert dataclasses.asdict(tdev.GritCaps()) == \
        dataclasses.asdict(jdev.GritCaps())
    assert tdev.OverflowReport.FIELDS == jdev.OverflowReport.FIELDS
    vec = [False, True, False, False, True, False, False]
    rep = tdev.OverflowReport.from_vector(vec)
    assert rep.overflowing() == ("frontier", "core_set") and bool(rep)
    assert rep.as_vector().tolist() == vec
    sc = get_scenario("duplicates-2d")
    pts = sc.points().astype(np.float32)
    res = tdev.device_dbscan(torch.as_tensor(pts), sc.eps, sc.min_pts,
                             tdev.GritCaps(grid_cap=64, grid_block=64))
    fields = convert.result_to_numpy(res)
    back = convert.result_from_numpy(
        **{k: v for k, v in fields.items() if k != "overflow"})
    assert torch.equal(back.labels, res.labels)
    assert back.report.overflowing() == res.report.overflowing()
    assert bool(back.overflow) == bool(res.overflow)
