"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python3 gritbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes its inputs from ``--seed``,
does its set-up (the kernels' library is built into the git-ignored
``build/repro_torch/`` of the checkout by the first run there, and
loaded by later ones), measures for ``--seconds`` seconds, then frees the
program's state and judges every answer of the run against the plain
float64 reference on the card.  Its last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read from a ``torch.profiler`` trace of the window and from the
program's counters), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit, also printed as
the last lines on standard error.

It exits non-zero and prints no result without a CUDA device (or with
fewer than the cell asks for), without the port's package, or when the
JAX package or JAX is loaded in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import sys
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from gritbench import harness  # noqa: E402
from gritbench.harness import BenchError  # noqa: E402


@dataclasses.dataclass
class Run:
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any            # where the program and the reference run
    ctx: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _forbid(where: str) -> None:
    bad = harness.forbidden_loaded()
    if bad:
        raise BenchError(f"{where}: modules of {harness.FORBIDDEN} are "
                         f"loaded in this process: {bad}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", cell: Optional[harness.Cell] = None) -> dict:
    """Drive one cell; returns the result's fields.  ``device="cpu"``
    (with a small ``cell``) is for the harness's own tests: it takes no
    device reading."""
    import torch
    cell = cell if cell is not None else harness.find_cell(name)
    on_card = torch.device(device).type == "cuda"
    run = Run(cell=cell, seed=int(seed), seconds=float(seconds),
              trace=bool(trace), device=device)
    kind = harness.driver(cell.traffic["kind"])
    drv = kind.Driver(run)
    drv.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = harness.process_age_s()
    tr = harness.DeviceTrace(cuda=on_card) if trace else None
    if tr is not None:
        with harness.HostSpans(kind.SPANS):
            tr.start()
            e2e = drv.window(tr)
            summary = tr.stop()
        harness.say(f"trace reduced: busy {summary['busy_s']:.3f} s of "
                    f"{summary['window_s']:.3f} s")
        drv.read_trace(summary)
    else:
        e2e = drv.window(None)
        summary = None
    _forbid("after the window")
    device_fields = harness.device_info(cell.chips) if on_card else \
        {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if trace:
        drv.traced_extras()
    drv.close()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    correct, attempted, failed, checks = drv.judge()
    _forbid("after the check")

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, dict] = {}
    breakdown = None
    if not trace:
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise BenchError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}
    else:
        run.ctx["trace"] = summary
        for m in cell.per_layer:
            v = harness.reader(m["name"])(run.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v),
                                      "unit": units[m["name"]]}
        device_fields["busy_s"] = summary["busy_s"]
        device_fields["window_s"] = summary["window_s"]
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
    return dict(correct=correct, attempted=attempted, failed=failed,
                metrics=metrics, device=device_fields, checks=checks,
                breakdown=breakdown, e2e=e2e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build of the program stays inside this checkout, at a fixed path
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    try:
        cell = harness.find_cell(args.workload)
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise BenchError(f"no src/repro_torch in {ROOT}: the program "
                             f"under test is missing")
        import torch
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: this benchmark measures the "
                             "card and never falls back to the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"{args.workload} needs {cell.chips} CUDA "
                             f"devices, {torch.cuda.device_count()} visible")
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), cell=cell)
    except BenchError as e:
        print(f"gritbench: {e}", file=sys.stderr, flush=True)
        return 2
    print(f"gritbench: {args.workload} seed {args.seed} e2e {out['e2e']}",
          file=sys.stderr, flush=True)
    harness.print_checks(out["checks"])
    print(harness.result_line(out["correct"], out["attempted"], out["failed"],
                              out["metrics"], out["device"], out["checks"],
                              out["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
