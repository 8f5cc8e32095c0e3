"""Port grid tree vs the JAX package: the device neighbor table (and its
overflow flags) equal to ``repro.core.grid_tree.device_neighbor_table``
on the reference's own grid tables (fed through ``convert``), for both
sweeps, and equal to the host ``GridTree``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import grid_tree as jtree, grids as jgrids
from repro.engine import estimate_caps as jestimate
from repro_torch import convert
from repro_torch.core import grid_tree as ttree, grids as tgrids
from repro_torch.data.scenarios import get_scenario

NAMES = ["blobs-1d", "blobs-2d", "blobs-3d", "blobs-4d", "cross-slab-2d",
         "duplicates-2d", "grid-boundary-2d", "simden-5d"]


def _ref_grids(name, pad=0):
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    caps = jestimate(pts, sc.eps, sc.min_pts)
    if pad:
        pts = np.concatenate([pts, np.full((pad, sc.d), 1e15, np.float32)])
    ref = jgrids.build_grids_device(jnp.asarray(pts), sc.eps, caps.grid_cap)
    fields = {f: np.asarray(getattr(ref, f))
              for f in tgrids.DeviceGrids.FIELDS}
    return ref, convert.device_grids_from_numpy(**fields), caps


def _assert_tables_equal(ref, got):
    for r, g, what in zip(ref, got, ("nbr", "nbr_off", "ovf_frontier",
                                     "ovf_k")):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_neighbor_table_equal(name):
    """Stage fed with the reference's previous stage: reference grid
    table in, neighbor table compared (self excluded, as the pipeline
    asks for it)."""
    ref_dg, dg, caps = _ref_grids(name)
    kw = dict(frontier_cap=caps.frontier_cap, k_cap=caps.k_cap,
              include_self=False)
    ref = jtree.device_neighbor_table(ref_dg.ids, ref_dg.num_grids, **kw)
    got = ttree.device_neighbor_table(dg.ids, dg.num_grids, **kw)
    _assert_tables_equal(ref, got)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    dense = jtree.device_neighbor_table(ref_dg.ids, ref_dg.num_grids,
                                        packed=False, **kw)
    _assert_tables_equal(dense, got)
    tables = convert.neighbor_table_to_numpy(got[0], got[1])
    back = convert.neighbor_table_from_numpy(*tables)
    assert torch.equal(back[0], got[0]) and torch.equal(back[1], got[1])


@pytest.mark.parametrize("name,kw,ref_kw", [
    ("blobs-2d", dict(frontier_cap=128, k_cap=64, include_self=True), {}),
    ("blobs-3d", dict(frontier_cap=4, k_cap=48, include_self=False), {}),
    ("blobs-3d", dict(frontier_cap=64, k_cap=4, include_self=False), {}),
    ("simden-5d", dict(frontier_cap=8, k_cap=8, include_self=True),
     dict(packed=False)),
    ("duplicates-2d", dict(frontier_cap=2, k_cap=300, include_self=False),
     {}),
])
def test_neighbor_table_equal_under_tiny_caps(name, kw, ref_kw):
    """Too-small caps truncate the same way and raise the same flags;
    a k_cap wider than the leaf level pads the same way (the reference's
    dense route too: the port has the one)."""
    ref_dg, dg, _ = _ref_grids(name, pad=5)
    ref = jtree.device_neighbor_table(ref_dg.ids, ref_dg.num_grids, **kw,
                                      **ref_kw)
    got = ttree.device_neighbor_table(dg.ids, dg.num_grids, **kw)
    _assert_tables_equal(ref, got)


def test_row_chunking_is_not_part_of_the_result(monkeypatch):
    _, dg, caps = _ref_grids("blobs-3d")
    kw = dict(frontier_cap=caps.frontier_cap, k_cap=caps.k_cap,
              include_self=False)
    whole = ttree.device_neighbor_table(dg.ids, dg.num_grids, **kw)
    monkeypatch.setattr(ttree, "ROW_CHUNK_ELEMS", 1)     # 64-row chunks
    assert int(dg.num_grids) > 64
    parts = ttree.device_neighbor_table(dg.ids, dg.num_grids, **kw)
    _assert_tables_equal(whole, parts)


@pytest.mark.parametrize("name", ["blobs-2d", "blobs-3d", "simden-5d"])
def test_device_table_agrees_with_host_grid_tree(name):
    """Rows of the device table hold exactly the host tree's neighbor
    sets, offsets ascending."""
    _, dg, caps = _ref_grids(name)
    ng = int(dg.num_grids)
    ids = dg.ids[:ng].numpy()
    nbr, off, ovf_f, ovf_k = ttree.device_neighbor_table(
        dg.ids, dg.num_grids, frontier_cap=256, k_cap=256)
    assert not bool(ovf_f) and not bool(ovf_k)
    indptr, grid, goff = ttree.GridTree.build(ids).query(ids)
    ref_indptr, ref_grid, ref_off = jtree.GridTree.build(ids).query(ids)
    np.testing.assert_array_equal(indptr, ref_indptr)
    np.testing.assert_array_equal(grid, ref_grid)
    np.testing.assert_array_equal(goff, ref_off)
    s_indptr, s_grid, s_off = ttree.stencil_neighbors(ids, ids)
    np.testing.assert_array_equal(indptr, s_indptr)
    np.testing.assert_array_equal(grid, s_grid)
    for g in range(ng):
        row = nbr[g].numpy()
        k = int((row >= 0).sum())
        assert k == indptr[g + 1] - indptr[g]
        assert set(row[:k]) == set(grid[indptr[g]:indptr[g + 1]])
        np.testing.assert_array_equal(off[g, :k].numpy(),
                                      goff[indptr[g]:indptr[g + 1]])
    assert (nbr[ng:] == -1).all()
