"""The control of ``correct``: the reference put in the program's place,
computed in float32 as a matrix product computes distances
(``|a|² + |b|² − 2 a·b``, TF32 off), and judged by the same comparison
as the program.

    python3 gritbench/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed with the numbers that ``run.py`` compares:
the control clusters the cell's points in the row order of the window's
first fit.  This script is not part of a benchmark run;
``gritbench/tests/`` keeps it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gritbench import data, harness  # noqa: E402
from gritbench.reference import brute  # noqa: E402

LOW = "float32-gemm"


def control_numbers(cell: harness.Cell, seed: int, device) -> dict:
    cfg, traffic = cell.config, cell.traffic
    eps, min_pts = float(cfg["eps"]), int(cfg["min_pts"])
    pts = data.cell_points(cfg, seed)
    ref = brute.dbscan(pts, eps, min_pts, device=device)
    k = int(traffic.get("warmup_fits", 1))
    order = data.row_order(seed, k, len(pts))
    low = brute.dbscan(pts[order], eps, min_pts, device=device,
                       precision=LOW)
    lab = np.empty(len(pts), np.int64)
    lab[order] = brute.labels_of(low)
    core = np.empty(len(pts), bool)
    core[order] = low.core
    got = brute.judge_fit(ref, lab, core)
    return {"core_flag_errors": got["core_flag_errors"],
            "label_errors": got["label_errors"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    for seed in args.seeds:
        nums = control_numbers(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": LOW, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
