"""Port grid construction vs the JAX package: ``DeviceGrids`` tables
equal field by field (integers and booleans equal, the float32 side /
origin / sorted points bit-equal: both sides do the same float32
arithmetic), plain and padded (``point_valid``) input."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import grids as jgrids
from repro.data.scenarios import get_scenario as jget
from repro.engine import estimate_caps as jestimate
from repro_torch import convert
from repro_torch.core import grids as tgrids
from repro_torch.core.device_dbscan import PAD_COORD
from repro_torch.data.scenarios import default_scenarios, get_scenario

NAMES = ["blobs-1d", "blobs-2d", "blobs-3d", "blobs-4d", "blobs-5d",
         "duplicates-2d", "grid-boundary-2d", "single-grid-3d",
         "collinear-3d", "cross-slab-2d", "simden-5d"]


def _assert_grids_equal(ref, got):
    out = convert.device_grids_to_numpy(got)
    for f in tgrids.DeviceGrids.FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)), out[f],
                                      err_msg=f"DeviceGrids.{f}")


def test_scenario_generators_draw_the_same_points():
    """The port's own copy of the catalogue yields the reference's data."""
    for sc in default_scenarios():
        ref = jget(sc.name)
        assert (sc.d, sc.n, sc.eps, sc.min_pts) == \
            (ref.d, ref.n, ref.eps, ref.min_pts)
        np.testing.assert_array_equal(sc.points(), ref.points())
        np.testing.assert_array_equal(sc.points(seed=3, n=97),
                                      ref.points(seed=3, n=97))


@pytest.mark.parametrize("name", NAMES)
def test_device_grids_equal(name):
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    cap = jestimate(pts, sc.eps, sc.min_pts).grid_cap
    ref = jgrids.build_grids_device(jnp.asarray(pts), sc.eps, cap)
    got = tgrids.build_grids_device(torch.as_tensor(pts), sc.eps, cap)
    _assert_grids_equal(ref, got)
    assert not bool(got.overflow)


@pytest.mark.parametrize("name", ["blobs-3d", "duplicates-2d", "line-1d"])
def test_device_grids_equal_on_padded_input(name):
    """Padding rows sit at PAD_COORD: clamped before the int cast, they
    share one sentinel grid that sorts after every real grid."""
    sc = get_scenario(name)
    pts = sc.points().astype(np.float32)
    n = len(pts)
    padded = np.full((n + 37, sc.d), PAD_COORD, np.float32)
    padded[:n] = pts
    cap = jestimate(pts, sc.eps, sc.min_pts).grid_cap
    ref = jgrids.build_grids_device(jnp.asarray(padded), sc.eps, cap)
    got = tgrids.build_grids_device(torch.as_tensor(padded), sc.eps, cap)
    _assert_grids_equal(ref, got)
    ng = int(got.num_grids)
    assert (got.ids[ng - 1] == tgrids.PAD_ID).all()
    assert int(got.counts[ng - 1]) == 37
    assert (got.order[-37:].numpy() >= n).all()
    assert (got.ids[:ng - 1] < tgrids.PAD_ID).all()


def test_truncated_grid_table_raises_the_same_flag():
    sc = get_scenario("blobs-2d")
    pts = sc.points().astype(np.float32)
    ref = jgrids.build_grids_device(jnp.asarray(pts), sc.eps, 8)
    got = tgrids.build_grids_device(torch.as_tensor(pts), sc.eps, 8)
    assert bool(got.overflow) and bool(ref.overflow)
    _assert_grids_equal(ref, got)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5])
def test_lex_order_is_the_stable_lexicographic_sort(d):
    rng = np.random.default_rng(d)
    ids = rng.integers(0, 4, size=(500, d)).astype(np.int32)
    ids[::7] = tgrids.PAD_ID            # sentinel rows among the keys
    want = np.lexsort(tuple(ids[:, j] for j in range(d - 1, -1, -1)))
    got = tgrids.lex_order(torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["blobs-3d", "grid-boundary-2d",
                                  "duplicates-2d"])
def test_host_grids_equal(name):
    sc = get_scenario(name)
    pts = sc.points()
    ref, got = jgrids.build_grids(pts, sc.eps), tgrids.build_grids(pts, sc.eps)
    for f in ("order", "ids", "starts", "counts", "point_grid", "mins"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f))
    assert (ref.side, ref.eta, ref.num_grids) == \
        (got.side, got.eta, got.num_grids)
    with pytest.raises(ValueError, match="empty"):
        tgrids.build_grids(np.zeros((0, 2)), 1.0)


def test_device_grids_round_trip_through_numpy():
    sc = get_scenario("blobs-3d")
    pts = sc.points().astype(np.float32)
    got = tgrids.build_grids_device(torch.as_tensor(pts), sc.eps, 256)
    fields = convert.device_grids_to_numpy(got)
    back = convert.device_grids_from_numpy(**fields)
    for f in tgrids.DeviceGrids.FIELDS:
        assert getattr(back, f).dtype == getattr(got, f).dtype
        assert torch.equal(getattr(back, f), getattr(got, f))
    fields.pop("mins")
    with pytest.raises(ValueError, match="missing"):
        convert.device_grids_from_numpy(**fields)
