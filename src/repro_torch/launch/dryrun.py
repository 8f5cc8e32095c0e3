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

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape all \\
      --device cpu --out build/dryrun.json
Without ``--device`` it runs on the CUDA device and raises when there is
none.  Every cell runs on one device (``mesh`` "1"): ``--mesh multi`` /
``both``, ``--seq-parallel``, ``--moe-alltoall`` and ``--cluster`` need
several cards (ROADMAP A18) and exit != 0.  Exit code != 0 on any cell
failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

NEEDS_A18 = ("needs a mesh of several cards, which the port does not have "
             "yet (ROADMAP A18); every cell here runs on one device")


def _tensor_leaves(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


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
             overrides=None) -> dict:
    """The dry-run record of one cell (module docstring); ``shape`` is a
    name of ``configs.SHAPES`` or a ``ShapeCfg``."""
    from ..configs import long_500k_supported
    from .roofline import roofline_terms
    from .specs import build_cell

    name = shape if isinstance(shape, str) else shape.name
    rec = {"arch": arch, "shape": name, "mesh": "1"}
    if name == "long_500k" and not long_500k_supported(arch):
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch: 500k decode is quadratic " \
                        "(see DESIGN.md shape-applicability)"
        return rec

    t0 = time.perf_counter()
    fn, args, info = build_cell(arch, shape, device=device,
                                attn_impl=attn_impl, overrides=overrides)
    rec.update(info)
    t1 = time.perf_counter()
    _, la, memory = count_cell(fn, args)
    t2 = time.perf_counter()
    rec.update({
        "status": "ok",
        "chips": 1,
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
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
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

    for flag, on in (("--mesh " + args.mesh, args.mesh != "single"),
                     ("--seq-parallel", args.seq_parallel),
                     ("--moe-alltoall", args.moe_alltoall),
                     ("--cluster", args.cluster)):
        if on:
            print(f"dryrun: {flag} {NEEDS_A18}", file=sys.stderr)
            return 2

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
            tag = f"{arch} x {shape} x 1"
            try:
                rec = run_cell(arch, shape, device=device,
                               attn_impl=args.attn_impl,
                               overrides=overrides or None)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": "1",
                       "status": "failed", "error": repr(e)}
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
