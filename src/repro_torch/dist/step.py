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

Where the shards run (``dist/comm.py``): all in this process, shard
``s`` on ``devices[s]`` (repeats allowed: several shards may share one
card), where every exchange is an explicit copy of a buffer to the
receiving shard's device; or one shard per rank of a ``DeviceMesh``
(``mesh=``), where the exchanges are collectives of the process group
and each rank runs its own shard.  Shard ``s`` takes the hi-edge buffer
of shard ``s - 1`` and the lo-edge buffer of shard ``s + 1`` (shard 0
has no left neighbour, the last shard no right one: their ghost buffers
are all padding), and the ghosts' locally assigned labels travel back
the same way.  Both forms compute the same tensors; the loop is what
``n_shards=`` on one device runs.

The step is staged by nature: :func:`make_staged_cluster_steps` returns
the three stages (halo exchange, local cluster, reconcile) as separate
functions, so a traced fit can wait between them and attribute wall
time to each; :func:`make_cluster_step` chains them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from ..core.device_dbscan import (GritCaps, OverflowReport, PAD_COORD,
                                  device_dbscan)

from .comm import GroupComm, LoopComm
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


def shard_comm(devices: Optional[Sequence] = None, mesh=None, device=None):
    """The moves of a step: :class:`~repro_torch.dist.comm.GroupComm`
    of this rank's shard on ``device`` when ``mesh`` is given, else
    :class:`~repro_torch.dist.comm.LoopComm` over ``devices``."""
    if mesh is not None:
        if devices is not None:
            raise ValueError("pass devices= or mesh=, not both")
        return GroupComm(mesh, device)
    return LoopComm(devices)


def make_staged_cluster_steps(devices: Optional[Sequence], eps, min_pts: int,
                              caps: ClusterCaps, *, mesh=None, device=None,
                              comm=None):
    """The cluster step as its three stages, over shard ``s`` on
    ``devices[s]``, or over this rank's shard of ``mesh`` on ``device``,
    or over the shards of ``comm`` (moves built by the caller, such as
    the dry run's over a fake process group).  Every argument and result
    is a list with one tensor per shard this process holds, on that
    shard's device.

    Returns ``(halo_fn, local_fn, reconcile_fn, comm)``:

    * ``halo_fn(points, valid) -> (ghosts_l, ghosts_r, lo_idx, hi_idx,
      halo_overflow)``
    * ``local_fn(points, valid, ghosts_l, ghosts_r) -> (labels, core,
      point_grid, gl_labels, gl_core, gr_labels, gr_core, report_vec)``
    * ``reconcile_fn(labels, core, gl_labels, gl_core, gr_labels,
      gr_core, lo_idx, hi_idx) -> global labels``
    * ``comm`` the moves (``dist/comm.py``); ``comm.shards`` are the
      global ids of the shards held.

    ``points[i]`` is ``[n, d]`` float32, ``valid[i]`` ``[n]`` bool,
    with one ``n`` for every shard (the packed slab width).
    """
    if comm is None:
        comm = shard_comm(devices, mesh, device)
    shards = comm.shards
    n_shards = comm.n_shards
    last = n_shards - 1
    L = caps.grit.grid_cap
    H = caps.halo_cap

    def halo_fn(points: List[torch.Tensor], valid: List[torch.Tensor]):
        lo = [halo_buffer(points[i], valid[i], eps, "lo", H)
              for i in range(len(shards))]
        hi = [halo_buffer(points[i], valid[i], eps, "hi", H)
              for i in range(len(shards))]
        # my left neighbour's hi-edge points, my right one's lo-edge
        ghosts_l, ghosts_r = comm.neighbour_exchange([b[0] for b in hi],
                                           [b[0] for b in lo], PAD_COORD)
        return (ghosts_l, ghosts_r, [b[1] for b in lo], [b[1] for b in hi],
                [l[2] | h[2] for l, h in zip(lo, hi)])

    def local_fn(points, valid, ghosts_l, ghosts_r):
        outs = []
        for i in range(len(shards)):
            pts, gl, gr = points[i], ghosts_l[i], ghosts_r[i]
            all_pts = torch.cat([pts, gl, gr])
            all_valid = torch.cat([
                valid[i], (gl < PAD_COORD / 2).any(dim=1),
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
        back_to_left = [torch.where(c, l, torch.full_like(l, -1))
                        for l, c in zip(gl_lab, gl_core)]
        back_to_right = [torch.where(c, l, torch.full_like(l, -1))
                         for l, c in zip(gr_lab, gr_core)]
        # the label my shipped points got at each neighbour, aligned
        # with my halo rows
        lo_remote, hi_remote = comm.neighbour_exchange(back_to_right, back_to_left, -1)
        edges, oks = [], []
        for i, s in enumerate(shards):
            e_hi, ok_hi = shared_point_edges(
                own_labels[i], own_core[i], hi_idx[i], hi_remote[i], s,
                min(s + 1, last), L)
            e_lo, ok_lo = shared_point_edges(
                own_labels[i], own_core[i], lo_idx[i], lo_remote[i], s,
                max(s - 1, 0), L)
            if s == last:
                ok_hi = torch.zeros_like(ok_hi)
            if s == 0:
                ok_lo = torch.zeros_like(ok_lo)
            edges.append(torch.cat([e_hi, e_lo]))            # [2H, 2]
            oks.append(torch.cat([ok_hi, ok_lo]))
        # global components over (shard, label) space
        gmap = global_component_map(edges, oks, n_shards, L, comm)
        out = []
        for i, s in enumerate(shards):
            lab = own_labels[i]
            g = gmap.to(lab.device)
            out.append(torch.where(
                lab >= 0, g[s * L + lab.clamp_min(0).to(torch.int64)],
                torch.full((), -1, dtype=g.dtype, device=lab.device)))
        return out

    return halo_fn, local_fn, reconcile_fn, comm


def make_cluster_step(devices: Optional[Sequence], eps, min_pts: int,
                      caps: ClusterCaps, *, mesh=None, device=None,
                      comm=None):
    """The three stages of :func:`make_staged_cluster_steps` chained.

    Returns ``fn(points, valid) -> (labels, core, point_grid, report)``:
    per-shard lists of the globally reconciled labels ([n] int32, -1
    noise), core flags and device grid rows, and one
    ``OverflowReport`` (0-d bool tensors) with each cap's flag OR-ed
    over every shard.
    """
    halo_fn, local_fn, reconcile_fn, comm = make_staged_cluster_steps(
        devices, eps, min_pts, caps, mesh=mesh, device=device, comm=comm)

    def cluster_step(points, valid):
        gl, gr, lo_idx, hi_idx, hov = halo_fn(points, valid)
        (labels, core, point_grid, gl_lab, gl_core, gr_lab, gr_core,
         flags) = local_fn(points, valid, gl, gr)
        labels = reconcile_fn(labels, core, gl_lab, gl_core, gr_lab,
                              gr_core, lo_idx, hi_idx)
        return (labels, core, point_grid,
                OverflowReport.from_vector(report_vector(flags, hov, comm)))

    return cluster_step


def report_vector(flags: List[torch.Tensor],
                  halo_overflow: List[torch.Tensor], comm) -> torch.Tensor:
    """Per-cap overflow flags OR-ed over every shard (``comm.shard_any``), the
    halo flags of the exchange folded in."""
    vecs = []
    for f, h in zip(flags, halo_overflow):
        v = f.clone()
        v[_HALO] = v[_HALO] | h
        vecs.append(v)
    return comm.shard_any(vecs)
