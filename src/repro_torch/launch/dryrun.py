"""Dry run of (arch x shape) cells on one device: count, allocate nothing.

The counterpart of the reference's ``repro.launch.dryrun``, which lowers
and compiles each cell over ShapeDtypeStructs and reads the compiled
program's memory analysis and loop-aware costs.  Here each cell
(``launch/specs.py::build_cell``: fake params, state, batch and cache)
runs once under ``FakeTensorMode`` with the accountant of
``launch/costs.py``: every operator of the eager program is counted and
no tensor is allocated.  Per cell it writes the reference's record:
``lower_s`` the seconds taken to build the cell, ``compile_s`` those of
the fake run, FLOPs / bytes / collective bytes per chip, the roofline
terms at the H100's peaks (``launch/roofline.py``), the library's own
count (``torch_flop_counter``, in place of ``xla_cost_analysis``), and
``memory``: the arguments' bytes, the outputs' (tensors the arguments do
not hold), ``temp_size`` the peak of the bytes the run held above its
arguments, and ``generated_code_size`` 0 (eager: nothing is compiled).

Meshes: by default each cell is one device's (``mesh`` "1").
``--mesh single`` / ``multi`` / ``both`` count one rank of the
reference's production meshes, 16 x 16 ("16x16") and 2 x 16 x 16
("2x16x16"), over a fake process group of 256 / 512 ranks in this
process (``launch.mesh.fake_world``): ``build_cell(mesh=...)`` places
the cell's tensors as ``DTensor`` s over fake shards, and the accountant
counts the rank's own operators plus the ``_c10d_functional``
collectives they start.  ``--seq-parallel`` and ``--moe-alltoall``
(without ``--mesh``: on 16 x 16) set the reference's two levers.  A mesh
record adds ``param_bytes_per_rank``, the bytes of the rank's param
shards.

``--cluster`` counts the paper's own workload instead: one rank's
distributed GriT-DBSCAN step (``dist/step.py::make_cluster_step``) on
the production meshes (``--mesh single``, the default here, / ``multi``
/ ``both``), :func:`run_cluster_cell`.  The fit reads data-dependent
sizes back to the host, which fake tensors cannot give, so this cell
runs on real tensors, a seeded shard of points on the device, over the
fake process group: the rank's own work is real, and the moves are
counted and deliver nothing of another rank (:func:`_fake_group_comm`:
the ghosts arrive as padding, a gather holds the rank's own block in
every slot).  The halo exchange's sends count as ``collective-permute``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape all \\
      --device cpu --out build/dryrun.json
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
      --mesh both --device cpu
  python -m repro_torch.launch.dryrun --cluster --mesh both --device cpu
Without ``--device`` it runs on the CUDA device and raises when there is
none.  Exit code != 0 on any cell failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

MESHES = {"one": [None], "single": [False], "multi": [True],
          "both": [False, True]}
# the paper's normalised cube [0, DOMAIN)^d: rank r's shard of the
# cluster cell lies in [r DOMAIN, (r + 1) DOMAIN) along dim 0
DOMAIN = 1e5
CLUSTER_RECIPE = ("blobs-3d: 4 gaussian blobs (sigma 900) + 5% uniform "
                  "noise in [0, 1e5)^d, one blob centred on each dim-0 "
                  "face (folded back into the cube), the cube offset by "
                  "rank * 1e5 along dim 0")


def mesh_name(multi_pod) -> str:
    return {None: "1", False: "16x16", True: "2x16x16"}[multi_pod]


def _tensor_leaves(tree):
    """The tensors of ``tree``; a ``DTensor`` as its local shard (the
    bytes one rank holds)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def count_cell(fn, args):
    """``fn(*args)`` under the accountant, and under the fake mode of its
    arguments when they are fake (a ``build_cell`` cell): (its result,
    the count, the memory record)."""
    import contextlib

    from torch._guards import detect_fake_mode

    from .costs import measure
    leaves = _tensor_leaves(args)
    with detect_fake_mode(leaves) or contextlib.nullcontext():
        result, counts = measure(fn, *args)
    held = {id(t) for t in leaves}
    memory = {
        "argument_size": sum(t.numel() * t.element_size() for t in leaves),
        "output_size": sum(t.numel() * t.element_size()
                           for t in _tensor_leaves(result)
                           if id(t) not in held),
        "temp_size": counts["peak_live_bytes"],
        "generated_code_size": 0,
    }
    return result, counts, memory


def run_cell(arch: str, shape, *, device=None, attn_impl=None,
             overrides=None, multi_pod=None, seq_parallel: bool = False,
             moe_alltoall: bool = False) -> dict:
    """The dry-run record of one cell (module docstring); ``shape`` is a
    name of ``configs.SHAPES`` or a ``ShapeCfg``.  ``multi_pod`` None is
    one device, False / True one rank of 16 x 16 / 2 x 16 x 16."""
    from ..configs import long_500k_supported

    name = shape if isinstance(shape, str) else shape.name
    rec = {"arch": arch, "shape": name, "mesh": mesh_name(multi_pod)}
    if name == "long_500k" and not long_500k_supported(arch):
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch: 500k decode is quadratic " \
                        "(see DESIGN.md shape-applicability)"
        return rec
    if multi_pod is None:
        return _count_record(rec, arch, shape, device, attn_impl, overrides,
                             None, seq_parallel, moe_alltoall)
    from .mesh import fake_world, make_production_mesh
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        return _count_record(rec, arch, shape, device, attn_impl, overrides,
                             mesh, seq_parallel, moe_alltoall)


def _count_record(rec, arch, shape, device, attn_impl, overrides, mesh,
                  seq_parallel, moe_alltoall) -> dict:
    from ..models import sharding_ctx
    from .specs import build_cell

    t0 = time.perf_counter()
    try:
        fn, args, info = build_cell(arch, shape, device=device,
                                    attn_impl=attn_impl, overrides=overrides,
                                    mesh=mesh, seq_parallel=seq_parallel,
                                    moe_alltoall=moe_alltoall)
        rec.update(info)
        t1 = time.perf_counter()
        _, la, memory = count_cell(fn, args)
        t2 = time.perf_counter()
    finally:
        sharding_ctx.set_policy(None)
        sharding_ctx.set_shardmap_moe(None)
    if mesh is not None:
        rec["param_bytes_per_rank"] = sum(
            t.numel() * t.element_size()
            for t in _tensor_leaves(args[0]["params"] if info["kind"] ==
                                    "train" else args[0]))
    rec.update({"status": "ok",
                "chips": 1 if mesh is None else mesh.mesh.numel()})
    return _counted(rec, la, memory, t1 - t0, t2 - t1)


def _counted(rec, la, memory, lower_s, compile_s) -> dict:
    """``rec`` with a count's fields: the seconds, per-chip FLOPs, bytes
    and collective bytes, the library's count, memory and roofline."""
    from .roofline import roofline_terms
    rec.update({
        "lower_s": lower_s,
        "compile_s": compile_s,
        "flops_per_chip": la["flops"],
        "bytes_per_chip": la["bytes"],
        "collective_bytes_per_chip": {
            k[5:]: v for k, v in la.items() if k.startswith("coll_") and v},
        "flops_by_class": la["flops_by_class"],
        "dot_flops": la["dot_flops"],
        "kernel_flops": la["kernel_flops"],
        "torch_flop_counter": la["torch_flop_counter"],
        "memory": memory,
        "roofline": roofline_terms(la["flops_by_class"], la["bytes"],
                                   la["coll_bytes"]),
    })
    return rec


def cluster_shard_points(n: int, d: int, rank: int, seed: int = 0):
    """Rank ``rank``'s shard of the cluster cell (``CLUSTER_RECIPE``),
    [n, d] float64 from ``seed``: every rank draws the same points, in
    its own cube."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_noise = max(n // 20, 1)
    centers = rng.uniform(0.15 * DOMAIN, 0.85 * DOMAIN, size=(4, d))
    centers[0, 0], centers[1, 0] = 0.0, DOMAIN
    which = rng.integers(0, 4, size=n - n_noise)
    pts = centers[which] + rng.normal(scale=900.0, size=(n - n_noise, d))
    pts = np.abs(np.concatenate(
        [pts, rng.uniform(0, DOMAIN, size=(n_noise, d))]))
    pts = np.minimum(np.where(pts >= DOMAIN, 2 * DOMAIN - pts, pts),
                     np.nextafter(DOMAIN, 0))
    pts[:, 0] += rank * DOMAIN
    return pts


def reference_cluster_caps():
    """The static caps of the reference's cluster cell
    (``repro.launch.dryrun.run_cluster_cell``).  They overflow on the
    seeded shard; a step's collective bytes depend on its caps alone."""
    from ..core.device_dbscan import GritCaps
    from ..dist.step import ClusterCaps
    return ClusterCaps(grit=GritCaps(grid_cap=256, frontier_cap=128,
                                     k_cap=32, c_cap=512, m_cap=256,
                                     pair_cap=1024, grid_block=64,
                                     pair_block=256), halo_cap=128)


def _fake_group_comm(mesh, device):
    """The moves of the dry run's cluster step: ``GroupComm`` over the
    fake process group, whose collectives run (and are counted) but
    deliver nothing of another rank.  Whatever the fake group leaves in
    the buffers, the received halos and labels are set to the fill
    (padding ghosts, no remote label) and every slot of a gather to this
    rank's own tensor, outside the accountant's view."""
    from torch.utils._python_dispatch import _disable_current_modes

    from ..dist.comm import GroupComm

    class FakeGroupComm(GroupComm):
        def neighbour_exchange(self, to_right, to_left, fill):
            got = super().neighbour_exchange(to_right, to_left, fill)
            with _disable_current_modes():
                for t in got[0] + got[1]:
                    t.fill_(fill)
            return got

        def shard_concat(self, tensors):
            out = super().shard_concat(tensors)
            (t,) = tensors
            with _disable_current_modes():
                out.view(self.n_shards, *t.shape).copy_(
                    t.expand(self.n_shards, *t.shape))
            return out

    return FakeGroupComm(mesh, device)


def fake_group_delivers(device) -> dict:
    """What the fake process group of ``launch.mesh.fake_world`` leaves
    on ``device`` (4 ranks, played as rank 1): ``recv`` "fill" when a
    receive leaves its buffer as it was, else "written"; ``all_gather``
    "own" when every slot holds this rank's tensor, else "other"."""
    import torch
    import torch.distributed as dist

    from ..dist.comm import all_gather
    from .mesh import fake_world
    with fake_world(4, rank=1):
        buf = torch.full((3,), -7, dtype=torch.int32, device=device)
        mine = torch.arange(1, 4, dtype=torch.int32, device=device)
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, mine, 0),
                 dist.P2POp(dist.irecv, buf, 0)]):
            work.wait()
        got = all_gather(mine, dist.group.WORLD)
        recv = "fill" if bool((buf == -7).all()) else "written"
        own = bool((got.view(4, 3) == mine).all())
    return {"recv": recv, "all_gather": "own" if own else "other"}


def run_cluster_cell(multi_pod: bool, *, n_points_shard: int = 4096,
                     d: int = 3, eps: float = 3000.0, min_pts: int = 10,
                     device=None, seed: int = 0, rank: int = 1,
                     use_kernels=None, caps=None) -> dict:
    """The dry-run record of the distributed GriT-DBSCAN step: rank
    ``rank`` of 16 x 16 (``multi_pod`` False) or 2 x 16 x 16, counted.

    The defaults are the reference's cell: 4,096 points a shard, d 3,
    eps 3,000, MinPts 10.  The reference counts one SPMD program, the
    same on every chip; rank 1 is an inner slab, which sends both halos
    (rank 0, an end slab, sends one).  The shard is
    :func:`cluster_shard_points` on ``device`` (the CUDA device by
    default), every row valid.  Caps: ``caps`` as given (one run, which
    may overflow: status "overflow"), else ``estimate_caps`` on the
    shard and a halo cap from its census, grown and rerun until the
    step's report is clean.  The last caps then run once more under the
    accountant (``compile_s``); ``lower_s`` is the seconds taken to
    build the data and the caps.  ``use_kernels`` None is the
    distributed engine's rule: the CUDA kernels on a CUDA device, the
    plain plane elsewhere.

    The record is the reference's (``arch`` "grit-cluster-step",
    ``kind`` "cluster", the count per chip, ``roofline``) with the
    count's own fields (``flops_by_class``, ``kernel_flops``,
    ``torch_flop_counter``, ``memory``; ``kernel_ops``, the calls,
    FLOPs and bytes counted for each of the port's kernels) and
    ``rank``, ``caps`` (the ``GritCaps`` fields and ``halo_cap``),
    ``attempts`` (the overflow trail, whose last caps the counted run
    repeats), ``core_points`` (the shard's core points), ``sent``
    (``dist.comm.SENT`` of the counted run), ``halo_live`` (live rows
    shipped to each side), ``ghosts`` "padding", ``fake_group``
    (:func:`fake_group_delivers`) and ``data``."""
    import dataclasses

    import numpy as np
    import torch

    from ..dist import comm as dist_comm
    from ..dist.halo import census_halo_cap
    from ..dist.step import ClusterCaps, make_cluster_step
    from ..engine.adaptive import (_pow2_at_least, adaptive_loop,
                                   estimate_caps, grow_caps, resolve_device)
    from .mesh import fake_world, make_production_mesh

    dev = resolve_device(device)
    world = 512 if multi_pod else 256
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not a rank of {world}")
    uk = dev.type == "cuda" if use_kernels is None else bool(use_kernels)
    n = int(n_points_shard)
    rec = {"arch": "grit-cluster-step", "shape": f"n{n}xd{d}",
           "mesh": mesh_name(multi_pod), "kind": "cluster", "rank": rank}
    fake = fake_group_delivers(dev)
    t0 = time.perf_counter()
    host = cluster_shard_points(n, d, rank, seed)
    x0 = host[:, 0]
    halo_live = {
        "lo": int((x0 <= x0.min() + 2 * eps).sum()) if rank > 0 else 0,
        "hi": int((x0 >= x0.max() - 2 * eps).sum()) if rank < world - 1
        else 0}
    pts = torch.as_tensor(host, dtype=torch.float32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    sized = caps is None
    if sized:
        caps = ClusterCaps(
            grit=estimate_caps(host.astype(np.float32), eps, min_pts,
                               use_kernels=uk),
            halo_cap=min(census_halo_cap(host, eps, 1), _pow2_at_least(n)))

    def grow(c, overflowed):
        grit, halo = c.grit, c.halo_cap
        flags = tuple(f for f in overflowed if f != "halo")
        if flags:
            grit = grow_caps(grit, flags, n=n + 2 * halo, d=d)
        if "halo" in overflowed:
            halo = _pow2_at_least(min(2 * halo, n))
        return ClusterCaps(grit=grit, halo_cap=halo)

    saved = dict(dist_comm.SENT)
    try:
        with fake_world(world, rank=rank):
            mesh = make_production_mesh(multi_pod=multi_pod, device=dev)

            def step_of(c):
                return make_cluster_step(None, eps, min_pts, c,
                                         comm=_fake_group_comm(mesh, dev))

            def run(c):
                return c, step_of(c)([pts], [valid])[3]

            if sized:
                caps, attempts = adaptive_loop(run, grow, lambda c: None,
                                               caps, max_retries=8)
            t1 = time.perf_counter()
            dist_comm.SENT.update(dict.fromkeys(dist_comm.SENT, 0))
            out, la, memory = count_cell(step_of(caps), ([pts], [valid]))
            t2 = time.perf_counter()
            sent = dict(dist_comm.SENT)
            rec["chips"] = mesh.mesh.numel()
    finally:
        dist_comm.SENT.update(saved)
    report = out[3].overflowing()
    trail = [a["overflow"] for a in attempts] if sized else [report]
    rec["core_points"] = int(out[1][0].sum())
    rec["kernel_ops"] = {k: v for k, v in la["ops"].items()
                         if k.startswith("repro_torch.")}
    rec["status"] = "overflow" if report else "ok"
    _counted(rec, la, memory, t1 - t0, t2 - t1)
    rec.update({
        "caps": {**dataclasses.asdict(caps.grit), "halo_cap": caps.halo_cap},
        "attempts": trail,
        "sent": sent, "halo_live": halo_live, "ghosts": "padding",
        "fake_group": fake,
        "data": {"recipe": CLUSTER_RECIPE, "n": n, "d": d, "eps": eps,
                 "min_pts": min_pts, "seed": seed},
    })
    return rec


def _cluster_main(args, device) -> int:
    """``--cluster``: the cluster record of each mesh of ``--mesh``."""
    results, failures = [], 0
    for mp in MESHES[args.mesh or "single"]:
        try:
            rec = run_cluster_cell(mp, device=device)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": "grit-cluster-step", "mesh": mesh_name(mp),
                   "kind": "cluster", "status": "failed", "error": repr(e)}
        failures += rec["status"] != "ok"
        results.append(rec)
        extra = ""
        if "roofline" in rec:
            r = rec["roofline"]
            extra = (f" bound={r['dominant']} t_c={r['t_compute']:.3e}s"
                     f" t_m={r['t_memory']:.3e}s"
                     f" t_x={r['t_collective']:.3e}s")
        print(f"[{rec['status']:7s}] grit-cluster-step x {rec['mesh']}"
              f"{extra}", flush=True)
    _write(args.out, results)
    return 1 if failures else 0


def _write(path, results) -> None:
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help="one: one device (the default); single: 16x16; "
                         "multi: 2x16x16; both (--seq-parallel, "
                         "--moe-alltoall and --cluster default to single)")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--moe-alltoall", action="store_true")
    ap.add_argument("--cluster", action="store_true",
                    help="dry-run the distributed GriT-DBSCAN step instead")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (e.g. attn_chunk=512)")
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, SHAPES
    from ..engine.adaptive import resolve_device

    device = resolve_device(args.device)
    if args.cluster:
        if args.mesh == "one":
            ap.error("--cluster counts a rank of the production meshes: "
                     "--mesh single, multi or both")
        return _cluster_main(args, device)
    mesh = args.mesh or ("single" if args.seq_parallel or args.moe_alltoall
                         else "one")
    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    results, failures = [], 0
    for arch in archs:
        for shape in shapes:
            for mp in MESHES[mesh]:
                tag = f"{arch} x {shape} x {mesh_name(mp)}"
                try:
                    rec = run_cell(arch, shape, device=device,
                                   attn_impl=args.attn_impl,
                                   overrides=overrides or None,
                                   multi_pod=mp,
                                   seq_parallel=args.seq_parallel,
                                   moe_alltoall=args.moe_alltoall)
                except Exception as e:
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(mp), "status": "failed",
                           "error": repr(e)}
                    failures += 1
                results.append(rec)
                extra = ""
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    extra = (f" bound={r['dominant']}"
                             f" t_c={r['t_compute']:.3e}s"
                             f" t_m={r['t_memory']:.3e}s"
                             f" t_x={r['t_collective']:.3e}s"
                             f" compile={rec['compile_s']:.2f}s")
                print(f"[{rec['status']:7s}] {tag}{extra}", flush=True)

    _write(args.out, results)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
