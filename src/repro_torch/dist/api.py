"""Host-facing entry points of the distributed plane.

:func:`distributed_fit` is the full fit: pre-shard on the host, run the
per-shard cluster step, unpermute -- returning, in original point
order, the globally reconciled labels *plus* the fitted provenance
(core flags, per-shard device grid rows) and the slab geometry (owning
shard and cut coordinates) that
:class:`repro_torch.index.ShardedGritIndex` builds from.

:func:`distributed_dbscan` keeps the legacy (labels, report) contract
on top of it.

Where the shards run: ``devices`` (one torch device per shard, repeats
allowed), or the shorthand ``n_shards`` shards all on ``device``, all in
this process; or ``mesh``, a ``DeviceMesh`` over a process group, one
shard per rank on the rank's ``device`` (the reference's ``mesh``).
Every rank is given the same points and returns the same result.
``device=None`` is the CUDA device and raises when there is none, as
every entry point of the port does; the tests pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.device_dbscan import OverflowReport
from ..core.sync import host_read
from ..engine.adaptive import resolve_device

from .halo import census_halo_cap, halo_census
from .sharding import pack_slabs, slab_cuts, unshard_by_perm
from .step import ClusterCaps, make_staged_cluster_steps, report_vector


@dataclasses.dataclass
class DistributedFitResult:
    """One distributed fit, unpermuted to original point order.

    ``point_grid`` is *per-shard* provenance: the device grid-table row
    of each point within its owning shard's local pipeline (f32
    identifiers -- provenance and diagnostics, not the float64 host
    partition, which the serving index rebuilds per slab).
    """

    labels: np.ndarray       # [n] int64 global cluster ids; -1 noise
    core: np.ndarray         # [n] bool core-point flags
    point_grid: np.ndarray   # [n] int32 per-shard device grid rows
    shard_of: np.ndarray     # [n] int64 owning shard of each point
    cut_coords: np.ndarray   # [n_shards - 1] float64 slab boundaries
    report: OverflowReport   # per-cap flags OR-ed over shards


def shard_devices(devices: Optional[Sequence] = None,
                  n_shards: Optional[int] = None,
                  device=None) -> List[torch.device]:
    """The device of every shard.

    * ``devices`` given: one shard per entry (``n_shards``, if also
      given, must match);
    * else ``n_shards`` shards, all on ``device``;
    * neither: one shard per visible CUDA device when ``device`` is
      ``None`` (the counterpart of a mesh over every device), else one
      shard on ``device``.

    ``None`` (as ``device`` or as an entry) is the CUDA device and
    raises when there is none.
    """
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices= must name at least one device")
        if n_shards is not None and int(n_shards) != len(devs):
            raise ValueError(f"n_shards={n_shards} but {len(devs)} "
                             f"devices given")
        return devs
    dev = resolve_device(device)
    if n_shards is None:
        if device is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [dev]
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return [dev] * int(n_shards)


def _census_metrics(pts_sh, valid_sh, eps, caps, n_shards, cap) -> None:
    """Padding-waste counters of one traced fit: how much of the halo
    exchange and of the packed slab slots carries real points."""
    reg = obs.registry()
    reg.counter("dist.fit.count").inc()
    sel, slots, worst = halo_census(pts_sh, valid_sh, eps, caps.halo_cap)
    reg.counter("dist.halo.points_selected").inc(sel)
    reg.counter("dist.halo.buffer_slots").inc(slots)
    # cap-sizing waste: slack of the worst-populated side's buffer (the
    # shared cap must cover it; lighter sides' slack is irreducible --
    # see halo_census)
    reg.gauge("dist.halo.padding_waste").set(
        1.0 - worst / caps.halo_cap if caps.halo_cap else 0.0)
    reg.gauge("dist.halo.fill").set(sel / slots if slots else 0.0)
    valid_total = int(np.sum(valid_sh))
    reg.counter("dist.pack.points").inc(valid_total)
    reg.counter("dist.pack.slots").inc(n_shards * cap)
    reg.gauge("dist.pack.padding_waste").set(
        1.0 - valid_total / (n_shards * cap) if cap else 0.0)


def distributed_fit(points: np.ndarray, eps: float, min_pts: int,
                    devices: Optional[Sequence] = None,
                    caps: Optional[ClusterCaps] = None,
                    pad_to: Optional[int] = None,
                    traced: Optional[bool] = None, *,
                    n_shards: Optional[int] = None,
                    device=None, mesh=None) -> DistributedFitResult:
    """Pre-shard, run the cluster step, unpermute (vectorized).

    ``devices`` / ``n_shards`` / ``device`` place the shards (see
    :func:`shard_devices`); with ``mesh`` every rank of its process
    group calls this with the same arguments, packs the same slabs,
    runs its own shard (mesh ranks flattened row-major are the slabs in
    order) on ``device``, and gets every shard's rows back, so each rank
    returns the same result; the report is OR-ed over the ranks, so an
    adaptive retry decides the same on each.  The report is truthy iff
    any static cap overflowed on any shard; a truthy report means every
    array is a truncated artifact and must not be trusted (the adaptive
    loop in ``repro_torch.engine`` grows the caps and retries before
    letting that escape).

    ``traced`` (default: ``repro_torch.obs`` tracing state) times the
    three stages apart -- halo exchange / local cluster / reconcile as
    spans that wait for their shards' outputs -- so the trace
    attributes the fit's wall-clock per stage; untraced, one
    ``dist.fit.spmd_step`` span covers them.  Both give the same
    results.
    """
    if traced is None:
        traced = obs.enabled()
    if mesh is not None:
        if devices is not None or n_shards is not None:
            raise ValueError("pass mesh= or devices= / n_shards=, not both")
        devs, n_sh = None, mesh.mesh.numel()
        device = resolve_device(device)
    else:
        devs = shard_devices(devices, n_shards, device)
        n_sh = len(devs)
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    if caps is None:
        # default grit caps, but a halo cap sized from the actual
        # boundary-band census (the adaptive engine additionally sizes
        # the grit caps per shard; see
        # repro_torch.engine.estimate_shard_caps)
        caps = ClusterCaps(halo_cap=census_halo_cap(pts, eps, n_sh))
    with obs.span("dist.fit", n=n, shards=n_sh, staged=traced):
        with obs.span("dist.fit.pack"):
            order, cut_idx, cut_coords = slab_cuts(pts, eps, n_sh)
            pts_sh, valid_sh, perm = pack_slabs(pts, order, cut_idx,
                                                pad_to=pad_to)
        cap = pts_sh.shape[1]
        if traced:
            _census_metrics(pts_sh, valid_sh, eps, caps, n_sh, cap)
        halo_fn, local_fn, reconcile_fn, comm = make_staged_cluster_steps(
            devs, eps, min_pts, caps, mesh=mesh, device=device)
        with obs.span("dist.fit.transfer") as sp:
            sh_pts = [torch.from_numpy(pts_sh[s]).to(dev)
                      for s, dev in zip(comm.shards, comm.devices)]
            sh_valid = [torch.from_numpy(valid_sh[s]).to(dev)
                        for s, dev in zip(comm.shards, comm.devices)]
            sp.sync(sh_pts, sh_valid)

        # traced: a span per stage, each waiting for its shards' outputs;
        # untraced: one dist.fit.spmd_step span over the three
        stage = obs.span if traced else (lambda name: obs.NOOP_SPAN)
        with (obs.NOOP_SPAN if traced
              else obs.span("dist.fit.spmd_step")) as step_sp:
            with stage("dist.fit.halo_exchange") as sp:
                gl, gr, lo_idx, hi_idx, hov = halo_fn(sh_pts, sh_valid)
                sp.sync(gl, gr, lo_idx, hi_idx, hov)
            with stage("dist.fit.local_cluster") as sp:
                (labels, core, point_grid, gl_lab, gl_core, gr_lab,
                 gr_core, flags) = local_fn(sh_pts, sh_valid, gl, gr)
                sp.sync(labels, core, point_grid, flags)
            with stage("dist.fit.reconcile") as sp:
                labels = reconcile_fn(labels, core, gl_lab, gl_core,
                                      gr_lab, gr_core, lo_idx, hi_idx)
                sp.sync(labels)
            step_sp.sync(labels, core, point_grid)
        vec = report_vector(flags, hov, comm)
        report = OverflowReport.from_vector(host_read(vec))

        with obs.span("dist.fit.unpack"):
            labels = unshard_by_perm(comm.host_rows(labels), perm,
                                     n).astype(np.int64)
            core = unshard_by_perm(comm.host_rows(core), perm, n,
                                   fill=False)
            point_grid = unshard_by_perm(comm.host_rows(point_grid), perm,
                                         n)
            shard_row = np.repeat(
                np.arange(n_sh, dtype=np.int64)[:, None], cap, axis=1)
            shard_of = unshard_by_perm(shard_row, perm, n)
    return DistributedFitResult(labels=labels, core=core,
                                point_grid=point_grid, shard_of=shard_of,
                                cut_coords=cut_coords, report=report)


def distributed_dbscan(points: np.ndarray, eps: float, min_pts: int,
                       devices: Optional[Sequence] = None,
                       caps: Optional[ClusterCaps] = None,
                       pad_to: Optional[int] = None, *,
                       n_shards: Optional[int] = None, device=None,
                       mesh=None) -> Tuple[np.ndarray, OverflowReport]:
    """Legacy wrapper: (labels in original point order, report).

    The report is a fresh host instance (Python bools) -- callers may
    keep or mutate it freely.  ``bool(report)`` keeps the legacy
    overflow-flag contract.
    """
    res = distributed_fit(points, eps, min_pts, devices, caps=caps,
                          pad_to=pad_to, n_shards=n_shards, device=device,
                          mesh=mesh)
    return res.labels, res.report
