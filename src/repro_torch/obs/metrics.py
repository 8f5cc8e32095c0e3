"""Process-wide counter / gauge / histogram registry.

Every subsystem used to log in its own ad-hoc dict schema (serve step
log, delta-engine stats, adaptive-cap attempt dicts, benchmark rows);
this registry is the one place those numbers accumulate so the
exporters (``repro_torch.obs.export``) and the viewer
(``repro_torch.obs.view``) can read them uniformly.  Instruments are
cheap host-side objects -- an ``inc`` is a lock-protected integer add,
never a device sync -- so they are always on (unlike spans, which cost
a sync at close and are gated by ``repro_torch.obs.enabled()``).

The registry is *instantiable*: the process-wide default
(:func:`registry`) collects cross-cutting counters (kernel builds,
dispatches, transfer counts), while components that need isolated
books -- one :class:`~repro_torch.serve.driver.ClusterServer` per
registry, say -- hold their own instance.

``install_build_hooks()`` routes the port's one-off kernel costs into
the default registry: every ``nvcc`` run of ``kernels/build.py``
counts ``kernels.build.compiles`` and feeds its wall seconds to the
histogram ``kernels.build.seconds``, and every library load counts
``kernels.build.loads`` (the reference counts its jit compiles here).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "counter", "gauge", "histogram", "install_build_hooks",
    "build_hooks_installed", "build_counts",
]


class Counter:
    """Monotone counter.  ``inc`` is atomic under the instrument lock,
    so concurrent increments (the serve driver's double-buffered step
    packs batch k+1 while step k's kernels run) are never lost."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar (plus a running max, for watermarks)."""

    __slots__ = ("name", "_value", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._max = float("-inf")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._max = max(self._max, float(v))

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        return self._max


class Histogram:
    """Raw-sample histogram.

    Keeps every observation (bounded by ``cap``; beyond it the sample
    list freezes and only count/sum accumulate) so percentile queries
    are exact over the kept window -- the serve driver's latency
    summary must report the same p50/p95 it reported when it computed
    them from the request list directly.
    """

    __slots__ = ("name", "cap", "count", "total", "_values", "_lock")

    def __init__(self, name: str, cap: int = 1 << 16):
        self.name = name
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._values: List[float] = []
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if len(self._values) < self.cap:
                self._values.append(v)

    def values(self) -> List[float]:
        with self._lock:
            return list(self._values)

    def percentile(self, q: float) -> float:
        vals = sorted(self.values())
        if not vals:
            return 0.0
        if len(vals) == 1:
            return vals[0]
        # linear interpolation between closest ranks (numpy's default),
        # so registry percentiles match np.percentile on the same data
        pos = (q / 100.0) * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create instrument registry (name -> instrument).

    A name is one kind of instrument forever: asking for a counter
    under an existing gauge name raises -- silent type drift is how
    dashboards rot.
    """

    def __init__(self) -> None:
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(inst).__name__}, "
                    f"asked for {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 1 << 16) -> Histogram:
        return self._get(name, Histogram, cap=cap)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: counters -> int, gauges -> {value, max},
        histograms -> {count, sum, mean, p50, p95, p99, max}."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, Any] = {}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out[name] = inst.value
            elif isinstance(inst, Gauge):
                out[name] = {"value": inst.value,
                             "max": inst.max if inst.max > float("-inf")
                             else inst.value}
            else:
                vals = inst.values()
                out[name] = {
                    "count": inst.count, "sum": inst.total,
                    "mean": inst.mean,
                    "p50": inst.percentile(50),
                    "p95": inst.percentile(95),
                    "p99": inst.percentile(99),
                    "max": max(vals) if vals else 0.0,
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT


def counter(name: str) -> Counter:
    return _DEFAULT.counter(name)


def gauge(name: str) -> Gauge:
    return _DEFAULT.gauge(name)


def histogram(name: str) -> Histogram:
    return _DEFAULT.histogram(name)


# --------------------------------------------------------------------------
# kernel-build bridge (one-off compile / load costs)
# --------------------------------------------------------------------------

_BUILD_HOOKS = {"installed": False}


def _on_build_event(event: str, seconds: Optional[float] = None,
                    **kw: Any) -> None:
    _DEFAULT.counter(f"kernels.build.{event}s").inc()
    if event == "compile" and seconds is not None:
        _DEFAULT.histogram("kernels.build.seconds").observe(seconds)


def install_build_hooks() -> bool:
    """Route ``kernels/build.py``'s events into the default registry.

    Each ``nvcc`` run increments ``kernels.build.compiles`` and feeds
    its wall seconds to ``kernels.build.seconds``; each library load
    increments ``kernels.build.loads``.  Installs once per process;
    returns whether the hooks are (now) installed.
    """
    if _BUILD_HOOKS["installed"]:
        return True
    from ..kernels import build
    build.add_listener(_on_build_event)
    _BUILD_HOOKS["installed"] = True
    return True


def build_hooks_installed() -> bool:
    return _BUILD_HOOKS["installed"]


def build_counts(snapshot: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, int]:
    """The kernel-build counters out of a snapshot (default: live)."""
    snap = snapshot if snapshot is not None else _DEFAULT.snapshot()
    return {k: v for k, v in snap.items()
            if k.startswith("kernels.build.") and isinstance(v, int)}
