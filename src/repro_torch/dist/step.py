"""The distributed cluster step: a per-shard loop over a list of devices.

Per shard: halo exchange (``repro_torch.dist.halo``), the exact local
GriT-DBSCAN pipeline on own + ghost points (``device_dbscan`` -- the
*full* device pipeline, so ``caps.grit.use_kernels`` routes the shard's
core/border distance plane through the CUDA kernels exactly as on a
single device), then cross-shard label reconciliation
(``repro_torch.dist.reconcile``).

The step returns, per shard, the globally reconciled labels *and* the
fitted provenance the serving plane keeps: per-point core flags and the
device grid row of every own point (``point_grid``).  That is what lets
``distributed_fit`` feed a :class:`repro_torch.index.ShardedGritIndex`
without re-deriving core status host-side.

Shard ``s`` lives on ``devices[s]`` (repeats allowed: several shards
may share one card).  Every exchange is an explicit copy of a buffer to
the receiving shard's device: shard ``s`` takes the hi-edge buffer of
shard ``s - 1`` and the lo-edge buffer of shard ``s + 1`` (shard 0 has
no left neighbour, the last shard no right one: their ghost buffers are
all padding), and the ghosts' locally assigned labels travel back the
same way.  On one device the copies cost nothing; the layout is the one
a set of cards joined by collectives would use.

The step is staged by nature: :func:`make_staged_cluster_steps` returns
the three stages (halo exchange, local cluster, reconcile) as separate
functions, so a traced fit can wait between them and attribute wall
time to each; :func:`make_cluster_step` chains them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from ..core.device_dbscan import (GritCaps, OverflowReport, PAD_COORD,
                                  device_dbscan)

from .halo import halo_buffer
from .reconcile import global_component_map, shared_point_edges

_HALO = OverflowReport.FIELDS.index("halo")


@dataclasses.dataclass(frozen=True)
class ClusterCaps:
    """Static caps of the distributed pipeline: the per-shard device
    caps (including the ``use_kernels`` distance-plane switch) plus the
    halo/edge exchange caps."""

    grit: GritCaps = GritCaps()
    halo_cap: int = 512          # max points shipped per boundary side;
                                 # also sizes the reconciliation edge
                                 # buffers (one edge per shipped point)


def make_staged_cluster_steps(devices: Sequence, eps, min_pts: int,
                              caps: ClusterCaps):
    """The cluster step as its three stages, over shard ``s`` on
    ``devices[s]``.  Every argument and result is a list with one
    tensor per shard, on that shard's device.

    Returns ``(halo_fn, local_fn, reconcile_fn)``:

    * ``halo_fn(points, valid) -> (ghosts_l, ghosts_r, lo_idx, hi_idx,
      halo_overflow)``
    * ``local_fn(points, valid, ghosts_l, ghosts_r) -> (labels, core,
      point_grid, gl_labels, gl_core, gr_labels, gr_core, report_vec)``
    * ``reconcile_fn(labels, core, gl_labels, gl_core, gr_labels,
      gr_core, lo_idx, hi_idx) -> global labels``

    ``points[s]`` is ``[n, d]`` float32, ``valid[s]`` ``[n]`` bool,
    with one ``n`` for every shard (the packed slab width).
    """
    devs = [torch.device(x) for x in devices]
    n_shards = len(devs)
    last = n_shards - 1
    L = caps.grit.grid_cap
    H = caps.halo_cap

    def halo_fn(points: List[torch.Tensor], valid: List[torch.Tensor]):
        lo = [halo_buffer(points[s], valid[s], eps, "lo", H)
              for s in range(n_shards)]
        hi = [halo_buffer(points[s], valid[s], eps, "hi", H)
              for s in range(n_shards)]
        ghosts_l, ghosts_r = [], []
        for s, dev in enumerate(devs):
            pad = torch.full((H, points[s].shape[1]), PAD_COORD,
                             dtype=torch.float32, device=dev)
            # my left neighbour's hi-edge points, my right one's lo-edge
            ghosts_l.append(hi[s - 1][0].to(dev) if s > 0 else pad)
            ghosts_r.append(lo[s + 1][0].to(dev) if s < last else pad)
        return (ghosts_l, ghosts_r, [b[1] for b in lo], [b[1] for b in hi],
                [lo[s][2] | hi[s][2] for s in range(n_shards)])

    def local_fn(points, valid, ghosts_l, ghosts_r):
        outs = []
        for s in range(n_shards):
            pts, gl, gr = points[s], ghosts_l[s], ghosts_r[s]
            all_pts = torch.cat([pts, gl, gr])
            all_valid = torch.cat([
                valid[s], (gl < PAD_COORD / 2).any(dim=1),
                (gr < PAD_COORD / 2).any(dim=1)])
            res = device_dbscan(all_pts.to(torch.float32), eps, min_pts,
                                caps.grit, point_valid=all_valid)
            n_own = pts.shape[0]
            outs.append((res.labels[:n_own], res.core[:n_own],
                         res.point_grid[:n_own],
                         res.labels[n_own:n_own + H],
                         res.core[n_own:n_own + H],
                         res.labels[n_own + H:], res.core[n_own + H:],
                         res.report.as_vector()))
        return tuple(list(col) for col in zip(*outs))

    def reconcile_fn(own_labels, own_core, gl_lab, gl_core, gr_lab,
                     gr_core, lo_idx, hi_idx):
        # my labels of the ghosts go back to their home shards
        back_to_left = [torch.where(gl_core[s], gl_lab[s],
                                    torch.full_like(gl_lab[s], -1))
                        for s in range(n_shards)]
        back_to_right = [torch.where(gr_core[s], gr_lab[s],
                                     torch.full_like(gr_lab[s], -1))
                         for s in range(n_shards)]
        edges, oks = [], []
        for s, dev in enumerate(devs):
            none = torch.full((H,), -1, dtype=torch.int32, device=dev)
            # the label my shipped points got at each neighbour, aligned
            # with my halo rows
            hi_remote = back_to_left[s + 1].to(dev) if s < last else none
            lo_remote = back_to_right[s - 1].to(dev) if s > 0 else none
            e_hi, ok_hi = shared_point_edges(
                own_labels[s], own_core[s], hi_idx[s], hi_remote, s,
                min(s + 1, last), L)
            e_lo, ok_lo = shared_point_edges(
                own_labels[s], own_core[s], lo_idx[s], lo_remote, s,
                max(s - 1, 0), L)
            if s == last:
                ok_hi = torch.zeros_like(ok_hi)
            if s == 0:
                ok_lo = torch.zeros_like(ok_lo)
            edges.append(torch.cat([e_hi, e_lo]))            # [2H, 2]
            oks.append(torch.cat([ok_hi, ok_lo]))
        # global components over (shard, label) space
        gmap = global_component_map(edges, oks, n_shards, L)
        out = []
        for s, dev in enumerate(devs):
            g = gmap.to(dev)
            lab = own_labels[s]
            out.append(torch.where(
                lab >= 0, g[s * L + lab.clamp_min(0).to(torch.int64)],
                torch.full((), -1, dtype=g.dtype, device=dev)))
        return out

    return halo_fn, local_fn, reconcile_fn


def make_cluster_step(devices: Sequence, eps, min_pts: int,
                      caps: ClusterCaps):
    """The three stages of :func:`make_staged_cluster_steps` chained.

    Returns ``fn(points, valid) -> (labels, core, point_grid, report)``:
    per-shard lists of the globally reconciled labels ([n] int32, -1
    noise), core flags and device grid rows, and one
    ``OverflowReport`` (0-d bool tensors on ``devices[0]``) with each
    cap's flag OR-ed over the shards.
    """
    halo_fn, local_fn, reconcile_fn = make_staged_cluster_steps(
        devices, eps, min_pts, caps)

    def cluster_step(points, valid):
        gl, gr, lo_idx, hi_idx, hov = halo_fn(points, valid)
        (labels, core, point_grid, gl_lab, gl_core, gr_lab, gr_core,
         flags) = local_fn(points, valid, gl, gr)
        labels = reconcile_fn(labels, core, gl_lab, gl_core, gr_lab,
                              gr_core, lo_idx, hi_idx)
        return (labels, core, point_grid,
                OverflowReport.from_vector(report_vector(flags, hov)))

    return cluster_step


def report_vector(flags: List[torch.Tensor],
                  halo_overflow: List[torch.Tensor]) -> torch.Tensor:
    """Per-cap overflow flags OR-ed over the shards (on the first
    shard's device), the halo flags of the exchange folded in."""
    dev = flags[0].device
    vec = torch.stack([f.to(dev) for f in flags]).any(dim=0)
    halo = torch.stack([h.to(dev) for h in halo_overflow]).any()
    vec[_HALO] = vec[_HALO] | halo
    return vec
