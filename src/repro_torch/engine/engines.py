"""The built-in engines behind :func:`repro_torch.engine.cluster`.

========== =============================================================
name       backing pipeline
========== =============================================================
brute      O(n^2) host oracle (``brute_dbscan``) -- the ground truth the
           conformance suite holds every other engine to.
grit       paper-faithful host GriT-DBSCAN (Alg 6: grid tree +
           FastMerging + BFS over seed grids).
grit-ldf   host GriT-DBSCAN-LDF (union-find, low-density-first, §5.2).
device     the device pipeline with *adaptive* static caps: estimated
           from grid statistics, grown geometrically on overflow (never
           silently truncated).  Plain broadcast distance plane (the
           in-pipeline oracle).
device-kernels
           the same pipeline with ``use_kernels=True``: core/border
           distances go through the hand-written CUDA kernels
           ``eps_count_batch`` / ``row_min_batch`` (see
           ``repro_torch.kernels.ops``).
distributed
           slab-sharded: the device pipeline per shard on own + ghost
           points, halo exchange and global label reconciliation
           (``repro_torch.dist``), adaptive caps; one device per shard
           (``devices=``) or ``n_shards`` shards on ``device``.
========== =============================================================

All engines take host numpy points and return
:class:`~repro_torch.engine.result.ClusterResult` with labels in
original point order.  The host engines ignore ``device``; the device
engines run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np

from .. import obs
from ..core.dbscan import brute_dbscan, grit_dbscan
from ..core.validate import core_flags

from .adaptive import (_pow2_at_least, adaptive_device_dbscan,
                       adaptive_loop, estimate_shard_caps, grow_caps,
                       resolve_device)
from .registry import register_engine
from .result import ClusterResult


@register_engine("brute", "O(n^2) host oracle (reference labels)")
def _brute_engine(points, eps, min_pts, *, device=None, chunk: int = 2048,
                  with_core: bool = True) -> ClusterResult:
    t0 = time.perf_counter()
    labels = brute_dbscan(points, eps, min_pts, chunk=chunk)
    core = core_flags(points, eps, min_pts, chunk=chunk) if with_core \
        else None
    return ClusterResult.build(
        labels, "brute", core=core,
        stats={"n": len(points), "t_total": time.perf_counter() - t0})


def _host_grit(points, eps, min_pts, variant: str, name: str,
               **opts) -> ClusterResult:
    r = grit_dbscan(points, eps, min_pts, variant=variant, **opts)
    return ClusterResult.build(r.labels, name, core=r.core, grid=r.grid,
                               stats=r.stats)


@register_engine("grit", "host GriT-DBSCAN (paper Algorithm 6)")
def _grit_engine(points, eps, min_pts, *, device=None,
                 neighbor_engine: str = "tree", merge_engine: str = "fast",
                 rng=None) -> ClusterResult:
    return _host_grit(points, eps, min_pts, "grit", "grit",
                      neighbor_engine=neighbor_engine,
                      merge_engine=merge_engine, rng=rng)


@register_engine("grit-ldf",
                 "host GriT-DBSCAN-LDF (union-find, low-density first)")
def _grit_ldf_engine(points, eps, min_pts, *, device=None,
                     neighbor_engine: str = "tree",
                     merge_engine: str = "fast", rng=None) -> ClusterResult:
    return _host_grit(points, eps, min_pts, "ldf", "grit-ldf",
                      neighbor_engine=neighbor_engine,
                      merge_engine=merge_engine, rng=rng)


def _pad_bucket(n: int, quantum: int = 128) -> int:
    """Pad n up to a coarse bucket, so the padded-input path (masked
    sentinel points) is the one every fit takes, as in the reference."""
    return max(quantum, (n + quantum - 1) // quantum * quantum)


# build_grids_device computes interval indices as floor((x - min)/side)
# in f32 and clamps them into [0, PAD_ID] before the int32 cast.  Both
# steps lose correctness silently once span/side gets large: beyond
# ~2^22 the f32 quotient's ulp approaches a whole grid cell, so a
# point's identifier can land cells away from its true cell and miss
# its eps-neighbors' stencils, and near 2^30 a top-edge valid point can
# round up onto the PAD_ID sentinel itself.  The device-backed engines
# reject such inputs host-side here.  Host engines are unaffected
# (float64/int64 identifiers).
def _check_device_grid_range(pts: np.ndarray, eps: float,
                             limit: int = 2 ** 22) -> None:
    d = pts.shape[1]
    side = float(eps) / np.sqrt(d)
    span = float((pts.max(axis=0) - pts.min(axis=0)).max())
    if span / side >= limit:
        raise ValueError(
            f"eps={eps} is too small for the coordinate span {span:.3g}: "
            f"span/side = {span / side:.3g} >= 2^22 exceeds the f32 "
            f"device-grid identifier range (grid assignment would "
            f"quantize by whole cells); rescale the data, increase eps, "
            f"or use a host engine (grit/grit-ldf)")


def _device_impl(points, eps, min_pts, name: str, *, device=None, caps=None,
                 use_kernels=None, max_retries: int = 8,
                 growth: float = 2.0,
                 pad_quantum: int = 128) -> ClusterResult:
    """Device pipeline with the adaptive-cap loop.

    Points are padded to a coarse size bucket (``pad_quantum``) with
    masked-out sentinel points and placed on ``device``.
    """
    t0 = time.perf_counter()
    dev = resolve_device(device)
    with obs.span("engine.cluster.prepare"):
        pts = np.asarray(points, np.float32)
        n, d = pts.shape
        _check_device_grid_range(pts, eps)
        n_pad = _pad_bucket(n, pad_quantum)
        padded = np.zeros((n_pad, d), np.float32)
        padded[:n] = pts
        valid = np.arange(n_pad) < n

    res, attempts = adaptive_device_dbscan(
        padded, eps, min_pts, caps, point_valid=valid,
        max_retries=max_retries, growth=growth, use_kernels=use_kernels,
        device=dev)
    with obs.span("engine.cluster.finish"):
        labels = res.labels[:n].cpu().numpy().astype(np.int64)
        core = res.core[:n].cpu().numpy()
        return ClusterResult.build(
            labels, name, core=core, attempts=attempts,
            overflow=attempts[-1]["overflow"],
            stats={"n": n, "n_padded": n_pad,
                   "retries": len(attempts) - 1, "device": str(dev),
                   "t_total": time.perf_counter() - t0})


@register_engine("device",
                 "device pipeline, adaptive static caps, plain broadcast "
                 "distance plane")
def _device_engine(points, eps, min_pts, **opts) -> ClusterResult:
    opts.setdefault("use_kernels", False)
    return _device_impl(points, eps, min_pts, "device", **opts)


@register_engine("device-kernels",
                 "device pipeline with the hand-written CUDA distance "
                 "kernels (eps_count_batch / row_min_batch)")
def _device_kernels_engine(points, eps, min_pts, **opts) -> ClusterResult:
    opts.setdefault("use_kernels", True)
    return _device_impl(points, eps, min_pts, "device-kernels", **opts)


@register_engine("distributed",
                 "slab-sharded pipeline (per-shard device_dbscan, halo "
                 "exchange + global label reconciliation), adaptive caps")
def _distributed_engine(points, eps, min_pts, *, device=None,
                        devices: Optional[Sequence] = None,
                        n_shards: Optional[int] = None, mesh=None,
                        caps=None,
                        use_kernels: Optional[bool] = None,
                        max_retries: int = 8,
                        growth: float = 2.0) -> ClusterResult:
    """Slab-sharded engine (``repro_torch.dist``).

    The shards run on ``devices`` (one per shard, repeats allowed), or
    ``n_shards`` shards on ``device``; with neither, one shard per
    visible CUDA device (see ``repro_torch.dist.shard_devices``); with
    ``mesh`` (a ``DeviceMesh``) one shard per rank of its process group,
    on the rank's ``device``: every rank calls ``cluster`` with the same
    points and gets the same result, and retries in lockstep, since each
    reads the report OR-ed over the ranks.  Caps
    are estimated from *per-shard* grid statistics
    (:func:`repro_torch.engine.estimate_shard_caps`), the halo cap from
    the boundary-band census (``repro_torch.dist.census_halo_cap``).

    ``use_kernels`` selects the shard-local distance plane (it rides on
    ``ClusterCaps.grit``): None picks the CUDA kernels when every shard
    is on a CUDA device and the plain broadcast plane otherwise; an
    explicit flag always wins, including over the plane carried by a
    caller-provided ``caps``.
    """
    from ..dist import ClusterCaps, census_halo_cap, distributed_fit
    from ..dist.api import shard_devices

    t0 = time.perf_counter()
    pts = np.asarray(points, np.float64)
    n, d = pts.shape
    _check_device_grid_range(pts, eps)
    if mesh is not None:
        devs, n_sh = [resolve_device(device)], mesh.mesh.numel()
    else:
        devs = shard_devices(devices, n_shards, device)
        n_sh = len(devs)
    if caps is None:
        uk = all(dv.type == "cuda" for dv in devs) if use_kernels is None \
            else bool(use_kernels)
        grit = estimate_shard_caps(pts, eps, min_pts, n_sh, use_kernels=uk)
        halo = min(census_halo_cap(pts, eps, n_sh), _pow2_at_least(n))
        caps = ClusterCaps(grit=grit, halo_cap=halo)
    elif use_kernels is not None and \
            caps.grit.use_kernels != bool(use_kernels):
        caps = dataclasses.replace(
            caps, grit=dataclasses.replace(caps.grit,
                                           use_kernels=bool(use_kernels)))

    def run(c):
        fit = (distributed_fit(pts, eps, min_pts, caps=c, mesh=mesh,
                               device=devs[0]) if mesh is not None else
               distributed_fit(pts, eps, min_pts, devs, caps=c))
        return fit, fit.report

    def grow(c, overflowed):
        # halo is measured from the raw points, so its flag stays
        # trustworthy even while the grid table is truncated
        grit = c.grit
        grit_flags = tuple(f for f in overflowed if f != "halo")
        if grit_flags:
            grit = grow_caps(grit, grit_flags, n=n, d=d, growth=growth)
        halo = c.halo_cap
        if "halo" in overflowed:
            halo = _pow2_at_least(min(int(halo * growth), n))
        return ClusterCaps(grit=grit, halo_cap=halo)

    fit, attempts = adaptive_loop(
        run, grow,
        lambda c: {**dataclasses.asdict(c.grit), "halo_cap": c.halo_cap},
        caps, max_retries)
    return ClusterResult.build(
        fit.labels, "distributed", core=fit.core, attempts=attempts,
        overflow=attempts[-1]["overflow"],
        stats={"n": n, "n_shards": n_sh, "retries": len(attempts) - 1,
               "use_kernels": attempts[-1]["caps"]["use_kernels"],
               "devices": [str(dv) for dv in devs],
               "t_total": time.perf_counter() - t0})
