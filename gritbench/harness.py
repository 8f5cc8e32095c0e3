"""What every cell shares: the manifest, the files found by name, the
device trace and its reduction, the per-layer readers, the result line.

Nothing here knows a cell, a configuration, a traffic mix or a metric by
name: ``BENCHMARK.json`` lists them, and their files are found as

* ``gritbench/configs/<config>.json``   (a configuration's sizes),
* ``gritbench/traffic/<traffic>.json``  (a mix's parameters; its
  ``kind`` names the driver ``gritbench/drivers/<kind>.py``),
* ``gritbench/metrics/<metric>.py``     (a per-layer metric's reader:
  ``read(ctx) -> float | None``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "gritbench"
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: device activity in a chrome trace of ``torch.profiler``
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "gritbench.window"
#: host ranges whose device time by name the reduction keeps
SPAN_PREFIX = "gritbench:"
TOP = 10
#: device operation names are cut to this length in the breakdown
NAME_CHARS = 160


class BenchError(RuntimeError):
    """A run that cannot produce a result (exits non-zero, prints none)."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no {path.name} at {ROOT}")
    return load_json(path)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration's file
    traffic: dict         # the traffic file
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports an end-to-end ``metric``."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg_file = ROOT / cfgs[w["config"]]["file"]
    traffic_file = BENCH / "traffic" / f"{w['traffic']}.json"
    for p in (cfg_file, traffic_file):
        if not p.exists():
            raise BenchError(f"missing {p.relative_to(ROOT)}")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, config=load_json(cfg_file),
                traffic=load_json(traffic_file), chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        raise BenchError(f"no reader {path.relative_to(ROOT)}")
    safe = "".join(c if c.isalnum() else "_" for c in metric)
    return load_module(path, f"gritbench_metric_{safe}").read


def driver(kind: str):
    """The module ``drivers/<kind>.py``: its ``Driver`` class, and its
    ``SPANS``, the calls into the program's layers that a traced window
    names (:class:`HostSpans`)."""
    path = BENCH / "drivers" / f"{kind}.py"
    if not path.exists():
        raise BenchError(f"no driver {path.relative_to(ROOT)}")
    return load_module(path, f"gritbench_driver_{kind}")


def say(line: str) -> None:
    """A progress line on standard error, with the process's age."""
    print(f"[{process_age_s():8.2f} s] {line}", file=sys.stderr, flush=True)


def forbidden_loaded() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# --------------------------------------------------------------------------
# the device trace
# --------------------------------------------------------------------------

def _merge(iv: np.ndarray) -> np.ndarray:
    """Union of [start, end) intervals, sorted."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.float64)


def reduce_trace(events: List[dict]) -> dict:
    """Busy and window seconds, device time by name, the longest idle
    gaps named by the innermost host operation running at their middle,
    from the events of a chrome trace of ``torch.profiler`` whose window
    is the host span ``WINDOW_SPAN``."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise BenchError(f"the trace has no {WINDOW_SPAN!r} span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    by_name: Dict[str, float] = {}
    iv = []
    for e in dev:
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) * 1e-6
        s, t = max(s, w0), min(t, w1)
        if t > s:
            iv.append((s, t))
    busy = _merge(np.asarray(iv, np.float64).reshape(-1, 2))
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN]
    hs = np.asarray([float(e["ts"]) for e in host], np.float64)
    hd = np.asarray([float(e.get("dur", 0.0)) for e in host], np.float64)
    idle = []
    for s, t in gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:TOP]:
        mid = 0.5 * (s + t)
        cover = np.flatnonzero((hs <= mid) & (hs + hd >= mid))
        name = (host[cover[np.argmin(hd[cover])]]["name"] if len(cover)
                else "host work outside any profiled operation")
        idle.append([name, float((t - s) * 1e-6)])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # device seconds by name inside each harness range (by the start of
    # the device operation; a range that ends in a wait holds its work)
    spans: Dict[str, Dict[str, float]] = {}
    if dev:
        ds = np.asarray([float(e["ts"]) for e in dev], np.float64)
        dd = np.asarray([float(e.get("dur", 0.0)) for e in dev], np.float64)
        for e in events:
            name = e.get("name", "")
            if e.get("ph") != "X" or e.get("cat") != "user_annotation" \
                    or not name.startswith(SPAN_PREFIX):
                continue
            s0 = float(e["ts"])
            inside = np.flatnonzero((ds >= s0) & (ds < s0 + float(e["dur"])))
            got = spans.setdefault(name, {})
            for i in inside:
                k = dev[i]["name"]
                got[k] = got.get(k, 0.0) + dd[i] * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[k[:NAME_CHARS], v] for k, v in ops],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in idle],
            "device_s_by_name": by_name, "spans": spans}


class DeviceTrace:
    """``torch.profiler`` over CPU and CUDA, with the window as the host
    span ``WINDOW_SPAN``; :meth:`stop` reduces its chrome trace (written
    under ``TMPDIR`` and removed)."""

    def __init__(self, cuda: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._cuda = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self._prof = profile(activities=acts)
        self._span = None
        self.summary: Optional[dict] = None

    def _sync(self) -> None:
        if self._cuda:
            self._torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import record_function
        self._sync()
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> dict:
        """End the traced window (once) and reduce it; later calls return
        the same summary."""
        if self.summary is not None:
            return self.summary
        self._sync()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory(prefix="gritbench-") as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            events = load_json(Path(path))["traceEvents"]
        self._prof = None
        self.summary = reduce_trace(events)
        return self.summary


class HostSpans:
    """Profiler ranges around the calls into the program's layers, for
    naming what the host does in a traced window: each ``(module path,
    attribute)`` is wrapped in ``record_function("gritbench:<attribute>")``
    while the object is entered."""

    def __init__(self, targets):
        self.targets = list(targets)
        self._saved = []

    @staticmethod
    def _wrap(fn, label):
        from torch.profiler import record_function

        def wrapped(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return wrapped

    def __enter__(self):
        for mod, attr in self.targets:
            owner = importlib.import_module(mod)
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, f"gritbench:{attr}"))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()
        return False


def kernel_seconds(by_name: Dict[str, float], part: str) -> float:
    return sum(v for k, v in by_name.items() if part in k)


# --------------------------------------------------------------------------
# the result
# --------------------------------------------------------------------------

def device_info(count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count),
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def print_checks(checks: Dict[str, dict]) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
