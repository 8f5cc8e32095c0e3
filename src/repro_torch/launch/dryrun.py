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
shards.  ``--cluster`` (the distributed GriT-DBSCAN step on the
production meshes) exits != 0: the port's fit reads data-dependent
sizes back to the host, which fake tensors cannot give, and its count
of the step's collective schedule per rank is still to be written.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape all \\
      --device cpu --out build/dryrun.json
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \\
      --mesh both --device cpu
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
NO_CLUSTER = ("counts no cluster step yet: the port's fit reads "
              "data-dependent sizes back to the host, which fake tensors "
              "cannot give (ROADMAP: the --cluster dry run)")


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
    """``fn(*args)`` of a ``build_cell`` cell under the fake mode of its
    arguments and the accountant: (its result, the count, the memory
    record)."""
    from torch._guards import detect_fake_mode

    from .costs import measure
    leaves = _tensor_leaves(args)
    with detect_fake_mode(leaves):
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
    from .roofline import roofline_terms
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
    rec.update({
        "status": "ok",
        "chips": 1 if mesh is None else mesh.mesh.numel(),
        "lower_s": t1 - t0,
        "compile_s": t2 - t1,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default=None, choices=list(MESHES),
                    help="one: one device (the default); single: 16x16; "
                         "multi: 2x16x16; both (--seq-parallel and "
                         "--moe-alltoall default to single)")
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

    if args.cluster:
        print(f"dryrun: --cluster {NO_CLUSTER}", file=sys.stderr)
        return 2
    mesh = args.mesh or ("single" if args.seq_parallel or args.moe_alltoall
                         else "one")

    from ..configs import ARCHS, SHAPES
    from ..engine.adaptive import resolve_device

    device = resolve_device(args.device)
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

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
