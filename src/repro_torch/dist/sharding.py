"""Host-side slab sharding for the distributed plane.

Points are slab-sharded along the leading (dim-0) grid coordinate with
cuts on *grid lines* (side eps/sqrt(d)), so a grid never straddles two
shards and every per-shard grid statistic is bounded by its global
counterpart (which is what lets ``estimate_caps`` run once, globally).

Everything here is vectorized numpy: the cut search is one
``searchsorted`` over the key-change boundaries and the per-shard pack /
unpack is a single scatter, so the host pre/post-processing stays
O(n log n) with no Python-level per-shard loops on the hot path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.device_dbscan import PAD_COORD


def slab_cuts(points: np.ndarray, eps: float, n_shards: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grid-line slab cuts along dim 0 (equal counts up to granularity).

    Returns ``(order, cut_idx, cut_coords)``:

    * ``order``      -- [n] stable permutation sorting points by the
      dim-0 grid key;
    * ``cut_idx``    -- [n_shards - 1] positions in ``order`` where each
      slab begins (nondecreasing; an empty slab repeats its neighbor's
      position);
    * ``cut_coords`` -- [n_shards - 1] float64 dim-0 coordinates of the
      cuts (the left edge of the first grid column of the right slab):
      a point belongs to slab ``s`` iff
      ``cut_coords[s-1] <= x0 < cut_coords[s]`` (ends open to +-inf).
    """
    pts = np.asarray(points, np.float64)
    n, d = pts.shape
    side = float(eps) / np.sqrt(d)
    x0min = float(pts[:, 0].min())
    key = np.floor((pts[:, 0] - x0min) / side).astype(np.int64)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    # valid cut positions: indices where the grid key changes
    bounds = np.flatnonzero(skey[1:] != skey[:-1]) + 1       # ascending
    tgts = (np.arange(1, n_shards) * n) // n_shards
    # move each equal-count target forward to the next grid line
    pos = np.searchsorted(bounds, tgts, side="left")
    cut_idx = np.where(pos < len(bounds),
                       bounds[np.minimum(pos, max(len(bounds) - 1, 0))]
                       if len(bounds) else n,
                       n).astype(np.int64)
    cut_idx = np.minimum(cut_idx, n)
    safe = np.minimum(cut_idx, n - 1)
    cut_coords = x0min + skey[safe] * side
    cut_coords = np.where(cut_idx >= n, np.inf, cut_coords)
    return order, cut_idx, cut_coords


def owner_of_slab(x0: np.ndarray, cut_coords: np.ndarray) -> np.ndarray:
    """Owning slab of each dim-0 coordinate (vectorized point location).

    de Berg et al.'s grid argument: point location in a slab partition
    is one binary search -- O(log shards), O(1) expected with the
    near-uniform cuts the equal-count policy produces.
    """
    return np.searchsorted(np.asarray(cut_coords, np.float64),
                           np.asarray(x0, np.float64),
                           side="right").astype(np.int64)


def shard_points_by_slab(points: np.ndarray, eps: float, n_shards: int,
                         pad_to: Optional[int] = None):
    """Host-side spatial pre-sharding (vectorized pack).

    Sorts by the dim-0 grid coordinate and cuts into ``n_shards`` slabs
    at grid-line boundaries (equal point counts up to grid granularity).
    Returns (padded [n_shards, cap, d] f32, valid [n_shards, cap] bool,
    perm with original indices [n_shards, cap]).
    """
    pts = np.asarray(points, np.float64)
    order, cut_idx, _ = slab_cuts(pts, eps, n_shards)
    return pack_slabs(pts, order, cut_idx, pad_to)


def pack_slabs(pts: np.ndarray, order: np.ndarray, cut_idx: np.ndarray,
               pad_to: Optional[int] = None):
    """Pack pre-computed slab cuts (:func:`slab_cuts` output) into the
    padded shard layout -- split out so a caller that also needs the
    cut coordinates sorts the points once, not twice."""
    n, d = pts.shape
    n_shards = len(cut_idx) + 1
    starts = np.concatenate([[0], cut_idx]).astype(np.int64)
    ends = np.concatenate([cut_idx, [n]]).astype(np.int64)
    counts = ends - starts
    need = int(max(counts.max(initial=0), 1))
    if pad_to is not None and pad_to < need:
        raise ValueError(
            f"pad_to={pad_to} is smaller than the largest slab ({need} "
            f"points); slab cuts land on grid lines, so per-shard counts "
            f"cannot be reduced below that")
    cap = pad_to or need
    out = np.full((n_shards, cap, d), PAD_COORD, np.float32)
    valid = np.zeros((n_shards, cap), bool)
    perm = np.full((n_shards, cap), -1, np.int64)
    # one scatter: sorted row i lands at (shard_of[i], slot[i])
    shard_of = np.searchsorted(cut_idx, np.arange(n), side="right")
    slot = np.arange(n) - starts[shard_of]
    out[shard_of, slot] = pts[order]
    valid[shard_of, slot] = True
    perm[shard_of, slot] = order
    return out, valid, perm


def unshard_by_perm(values: np.ndarray, perm: np.ndarray,
                    n: int, fill=-1) -> np.ndarray:
    """Invert :func:`shard_points_by_slab`'s permutation (vectorized).

    ``values`` is [n_shards, cap] (or [n_shards * cap]) in shard layout;
    returns [n] in original point order, ``fill`` where no shard row
    mapped (never happens for a complete perm).
    """
    vals = np.asarray(values).reshape(perm.shape[0], perm.shape[1], -1)
    out_shape = (n,) if vals.shape[-1] == 1 else (n, vals.shape[-1])
    out = np.full(out_shape, fill, vals.dtype)
    m = perm >= 0
    out[perm[m]] = vals[m].squeeze(-1) if vals.shape[-1] == 1 else vals[m]
    return out


def halo_bound(points: np.ndarray, eps: float) -> int:
    """Max number of points any 2*eps-wide dim-0 window can contain --
    an upper bound on one shard's halo shipment."""
    x = np.sort(np.asarray(points, np.float64)[:, 0])
    hi = np.searchsorted(x, x + 2.0 * eps, side="right")
    return int((hi - np.arange(len(x))).max())
