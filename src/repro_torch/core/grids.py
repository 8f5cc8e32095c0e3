"""Grid construction (paper Algorithm 1).

Each dimension of the feature space is divided into intervals of length
``eps / sqrt(d)``; a point's grid *identifier* is the d-vector of its
interval indices (eq. (1) of the paper).  Points are then sorted
lexicographically by identifier (the paper uses radix sort; a stable
multi-key sort is the vectorized equivalent) so points of the same grid
are adjacent, and the non-empty grids are read off as a CSR partition
of the sorted order.

Two implementations share the same semantics:

* ``build_grids``        -- host path (numpy, dynamic shapes): used by the
                            host engines and the cap estimator.
* ``build_grids_device`` -- device path (torch, static ``grid_cap``): runs
                            where its input tensor lives.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GridIndex:
    """CSR view of the non-empty grids over a sorted point order (host)."""

    order: np.ndarray        # [n]   permutation: points sorted by grid id
    ids: np.ndarray          # [G,d] identifiers of non-empty grids (lex-sorted)
    starts: np.ndarray       # [G]   start of each grid's points in `order`
    counts: np.ndarray       # [G]   points per grid
    point_grid: np.ndarray   # [n]   grid index (into ids) of each point, original order
    side: float              # grid side length eps/sqrt(d)
    mins: np.ndarray         # [d]   per-dim minimum used as the origin
    eta: int                 # max interval index over all dims (paper's eta)

    @property
    def num_grids(self) -> int:
        return int(self.ids.shape[0])


def identifiers(points: np.ndarray, eps: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Eq. (1): per-point grid identifiers. Returns (ids[n,d], mins[d], side)."""
    points = np.asarray(points)
    d = points.shape[1]
    side = float(eps) / np.sqrt(d)
    mins = points.min(axis=0)
    ids = np.floor((points - mins[None, :]) / side).astype(np.int64)
    return ids, mins, side


def group_rows(ids: np.ndarray):
    """Lex-sort integer id rows and read off the run (grid) structure.

    The shared core of Algorithm 1, also used by the fitted index's
    insert splice and the kernel predict's query grouping.  Returns
    ``(order, sorted_ids, starts, counts, group_of_sorted)``: a stable
    lexicographic permutation, the sorted rows, CSR boundaries of each
    run of equal rows, and each sorted row's run index.
    """
    ids = np.asarray(ids)
    n, d = ids.shape
    order = np.lexsort(tuple(ids[:, j] for j in range(d - 1, -1, -1)))
    sids = ids[order]
    new = np.ones(n, dtype=bool)
    if n:
        new[1:] = np.any(sids[1:] != sids[:-1], axis=1)
    starts = np.flatnonzero(new).astype(np.int64)
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    group_of = np.cumsum(new) - 1
    return order, sids, starts, counts, group_of


def build_grids(points: np.ndarray, eps: float) -> GridIndex:
    """Algorithm 1 (host). O(n log n) via lexsort (radix-family, stable)."""
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    # n == 0 must fail *here*, not as an opaque reduction error inside
    # identifiers(); the public API (engine.cluster) validates earlier
    # still, with the same message style
    if n == 0:
        raise ValueError("empty point set")
    ids, mins, side = identifiers(pts, eps)
    order, sids, starts, counts, grid_of_sorted = group_rows(ids)
    point_grid = np.empty(n, dtype=np.int64)
    point_grid[order] = grid_of_sorted
    gids = sids[starts]
    eta = int(ids.max()) if n else 0
    return GridIndex(order=order, ids=gids, starts=starts, counts=counts,
                     point_grid=point_grid, side=side, mins=mins, eta=eta)


# --------------------------------------------------------------------------
# Device path: identical semantics, static shapes (grid_cap), torch.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceGrids:
    """Static-shape grid partition living on the device of its tensors.

    Grids beyond ``num_grids`` are padding: ids == PAD_ID sentinel,
    counts == 0.
    """

    sorted_points: torch.Tensor  # [n, d] f32 points permuted to grid order
    order: torch.Tensor          # [n]    int32 original index of each sorted point
    ids: torch.Tensor            # [G_cap, d] int32 identifiers (lex-sorted, padded)
    starts: torch.Tensor         # [G_cap] int32
    counts: torch.Tensor         # [G_cap] int32 (0 for padding)
    point_grid: torch.Tensor     # [n] int32 grid index of each *sorted* point
    num_grids: torch.Tensor      # [] int32
    side: torch.Tensor           # [] f32
    mins: torch.Tensor           # [d] f32
    overflow: torch.Tensor       # [] bool: true grid count exceeded G_cap

    FIELDS = ("sorted_points", "order", "ids", "starts", "counts",
              "point_grid", "num_grids", "side", "mins", "overflow")


PAD_ID = 2 ** 30


def lex_order(ids: torch.Tensor) -> torch.Tensor:
    """Stable lexicographic permutation of integer rows ``[n, d]``: d
    successive stable sorts from the last key to the first (a packed
    int64 key would only fit d <= 2 with identifiers up to PAD_ID)."""
    n, d = ids.shape
    order = torch.arange(n, device=ids.device)
    for j in range(d - 1, -1, -1):
        perm = torch.sort(ids[order, j], stable=True).indices
        order = order[perm]
    return order


def build_grids_device(points: torch.Tensor, eps, grid_cap: int) -> DeviceGrids:
    """Algorithm 1 on the device of ``points``.  Shapes static given
    ``grid_cap``; no host synchronisation."""
    n, d = points.shape
    dev = points.device
    side = (torch.tensor(eps, dtype=torch.float32, device=dev)
            / torch.sqrt(torch.tensor(float(d), dtype=torch.float32,
                                      device=dev)))
    mins = points.min(dim=0).values
    # Clamp identifiers into [0, PAD_ID] *before* the int32 cast:
    # padding points sit at PAD_COORD (~1e15), whose raw interval index
    # overflows int32, and an out-of-range float->int conversion is
    # undefined -- it may wrap negative and lex-sort the padding grids
    # *ahead of* every real grid, corrupting point_grid/starts.
    # Clamped, every out-of-range (or non-finite) coordinate lands
    # exactly on the PAD_ID sentinel, so padding points share one
    # sentinel grid that sorts after all real grids.  A *valid* point
    # can only reach the clamp when span/side >= 2^30 -- but the f32
    # quotient already quantizes by whole cells beyond ~2^22, so the
    # engine layer rejects span/side >= 2^22 host-side
    # (engines._check_device_grid_range).
    idf = torch.floor((points - mins[None, :]) / side)
    idf = torch.where(torch.isfinite(idf), idf,
                      torch.full_like(idf, float(PAD_ID)))
    ids = torch.clamp(idf, 0.0, float(PAD_ID)).to(torch.int32)

    order = lex_order(ids)
    sids = ids[order]                                  # [n, d]
    sorted_points = points[order]

    new = torch.ones((n,), dtype=torch.bool, device=dev)
    new[1:] = (sids[1:] != sids[:-1]).any(dim=1)
    grid_of_sorted = torch.cumsum(new.to(torch.int32), dim=0) - 1
    num_grids = (grid_of_sorted[-1] + 1).to(torch.int32)
    overflow = num_grids > grid_cap
    g = torch.clamp_max(grid_of_sorted, grid_cap - 1)   # int64

    rows = torch.arange(n, device=dev)
    starts = torch.full((grid_cap,), n, dtype=torch.int64, device=dev)
    starts.scatter_reduce_(0, g, rows, "amin", include_self=True)
    filled = torch.zeros((grid_cap,), dtype=torch.int64, device=dev)
    filled.index_add_(0, g, torch.ones_like(g))
    live = torch.arange(grid_cap, device=dev) < num_grids
    counts = torch.where(live, filled, torch.zeros_like(filled))
    # identifier of each grid row, read from the last point written to
    # it (all points of a grid share one identifier; a truncated table
    # funnels the excess grids into the last row, whose identifier is
    # then that of the last point, as a sequential scatter leaves it)
    last = torch.clamp(starts + filled - 1, 0, n - 1)
    gids = torch.where((live & (filled > 0))[:, None], sids[last],
                       torch.full_like(sids[last], PAD_ID))

    return DeviceGrids(sorted_points=sorted_points,
                       order=order.to(torch.int32), ids=gids,
                       starts=starts.to(torch.int32),
                       counts=counts.to(torch.int32),
                       point_grid=g.to(torch.int32), num_grids=num_grids,
                       side=side, mins=mins, overflow=overflow)
