"""Halo compaction for the slab exchange.

Each shard ships the points within 2*eps of its slab boundary to the
adjacent shard (an explicit copy to the neighbour's device, see
``repro_torch.dist.step``).  The 2*eps width guarantees a shipped
point's own eps-neighborhood is complete on the receiving side for any
point within eps of the boundary -- the width the reconciliation
exactness argument needs (DESIGN.md §5).

The buffers are fixed-cap (``ClusterCaps.halo_cap``) so every shard
ships the same shape; selection overflow is reported, never silently
truncated (the adaptive driver grows the cap and retries).
:func:`halo_buffer` works on tensors on the shard's device; the census
helpers are host numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.device_dbscan import PAD_COORD


def halo_buffer(pts: torch.Tensor, valid: torch.Tensor, eps, side: str,
                cap: int):
    """Compact the points within 2*eps of the slab's dim-0 edge into a
    fixed-cap buffer.

    Args:
      pts: [n, d] float32 shard-local points (padding rows at
        ``PAD_COORD``).
      valid: [n] bool.
      side: "lo" (points near the slab's min edge) or "hi" (max edge).
      cap: buffer size.  ``cap > n`` is legal: the buffer's tail beyond
        the ``n`` selectable points is explicit padding (``PAD_COORD``
        coordinates, index -1), and overflow can then never fire (at
        most ``n`` points are selectable).

    Returns ``(buf [cap, d] float32, idx [cap] int32 rows into pts or
    -1, overflow [] bool)``, all on the device of ``pts``.
    """
    x0 = pts[:, 0]
    inf = torch.full_like(x0, float("inf"))
    lo = torch.where(valid, x0, inf).min()
    hi = torch.where(valid, x0, -inf).max()
    near = valid & ((x0 <= lo + 2 * eps) if side == "lo"
                    else (x0 >= hi - 2 * eps))
    # compact the selected points into the buffer front: a stable sort
    # of an integer copy of the mask (selected rows first, in row order)
    n = pts.shape[0]
    order = torch.argsort((~near).to(torch.int32), stable=True)
    if n < cap:
        order = torch.cat([order, order.new_zeros(cap - n)])
        sel = torch.cat([near[order[:n]], near.new_zeros(cap - n)])
    else:
        order = order[:cap]
        sel = near[order]
    buf = torch.where(sel[:, None], pts[order],
                      torch.full((), PAD_COORD, dtype=pts.dtype,
                                 device=pts.device))
    idx = torch.where(sel, order, torch.full_like(order, -1))
    overflow = near.sum() > cap
    return buf.to(torch.float32), idx.to(torch.int32), overflow


def boundary_census(points: np.ndarray, eps: float, n_shards: int) -> int:
    """Worst per-side 2*eps boundary-band population of the slab
    partition: the exact host-side mirror of :func:`halo_buffer`'s
    selection predicate, maximized over every shard and both sides.

    ``slab_cuts`` is deterministic, so a ``halo_cap >= boundary_census``
    can never overflow on the fit that sized it -- unlike the
    ``halo_bound`` densest-window estimate, which bounds *any* window."""
    from .sharding import slab_cuts
    pts = np.asarray(points, np.float64)
    order, cut_idx, _ = slab_cuts(pts, eps, n_shards)
    starts = np.concatenate([[0], cut_idx]).astype(np.int64)
    ends = np.concatenate([cut_idx, [len(pts)]]).astype(np.int64)
    x = pts[order, 0]
    worst = 0
    for s in range(n_shards):
        seg = x[starts[s]:ends[s]]
        if not seg.size:
            continue
        worst = max(worst,
                    int(np.sum(seg <= seg.min() + 2 * eps)),
                    int(np.sum(seg >= seg.max() - 2 * eps)))
    return worst


def _quarter_pow2_at_least(x: int, lo: int = 8) -> int:
    """Smallest value >= x on the quarter-pow2 ladder (1, 1.25, 1.5,
    1.75 x 2^e): few distinct shapes like a plain pow2 bucket, but the
    over-provisioning is bounded at 25% instead of 100%."""
    x = max(int(x), lo, 8)
    e = max((x - 1).bit_length() - 1, 3)
    for m in (5, 6, 7, 8):
        v = (1 << e) * m // 4
        if v >= x:
            return v
    return 1 << (e + 1)


def census_halo_cap(points: np.ndarray, eps: float, n_shards: int,
                    lo: int = 32) -> int:
    """Halo cap sized from the actual boundary-band census (see
    :func:`boundary_census`), bucket-quantized on the quarter-pow2
    ladder (the reference's caps, so both packages fit the same
    shapes)."""
    return _quarter_pow2_at_least(boundary_census(points, eps, n_shards),
                                  lo=lo)


def halo_census(pts_sh: np.ndarray, valid_sh: np.ndarray, eps: float,
                cap: int) -> Tuple[int, int, int]:
    """Host-side mirror of :func:`halo_buffer`'s selection predicate
    over all shards and both sides.

    Returns ``(points_selected, buffer_slots, worst_side)`` where
    ``buffer_slots = 2 * n_shards * cap`` and ``worst_side`` is the
    largest single side's selection.  The cap-sizing padding waste is
    ``1 - worst_side / cap``: every shard ships one shared buffer shape,
    so the cap must cover the worst side and the slack on lighter sides
    is irreducible (the ``dist.halo.padding_waste`` gauge).  Pure numpy
    on the pre-packed slabs; never touches a device.
    """
    pts_sh = np.asarray(pts_sh)
    valid_sh = np.asarray(valid_sh, bool)
    n_shards = pts_sh.shape[0]
    selected, worst = 0, 0
    for s in range(n_shards):
        v = valid_sh[s]
        if not v.any():
            continue
        x0 = pts_sh[s, :, 0]
        xv = x0[v]
        lo, hi = float(xv.min()), float(xv.max())
        n_lo = int(np.sum(v & (x0 <= lo + 2 * eps)))
        n_hi = int(np.sum(v & (x0 >= hi - 2 * eps)))
        selected += n_lo + n_hi
        worst = max(worst, n_lo, n_hi)
    return selected, 2 * n_shards * cap, worst
