"""Nestable span tracer with device-sync-aware timing.

Overhead contract (same as the reference's ``repro.obs.trace``):

* **Tracing off** (the default): :func:`span` returns one shared
  module-level no-op object -- no event record, no attribute dict
  walk, and crucially *no host sync*, so the serving hot path is
  untouched and the ``hot-path-sync`` lint rule stays green by
  construction.
* **Tracing on**: a span syncs *only at its close*, and only when the
  caller registered tensors to wait for (``Span.sync(...)`` or the
  ``sync=`` kwarg): at close it records one CUDA event on the current
  stream of each device those tensors live on and waits for it, so the
  recorded duration covers the device work the stage enqueued, not
  just the Python that enqueued it.  CPU tensors and other values need
  no wait.  That close-time wait is the only host sync the tracer ever
  performs, and it carries a justified ``grit-lint`` pragma.

Spans nest lexically (context managers); the tracer keeps a per-thread
stack so the exporter can emit parent-ordered Chrome trace events and
the viewer can compute self-times.  Timestamps are
``time.perf_counter`` microseconds relative to the tracer's start --
monotonic, which is what Perfetto wants.

While a ``torch.profiler`` session is recording, each enabled span also
opens a ``record_function`` range of its own name, so a span lies in
the profiler's timeline beside the device work it enqueued and an idle
gap of the device trace is named by the innermost span around it.
Without a recording profiler no range is opened (the check is one
``torch.autograd._profiler_enabled()`` call).

:class:`Stages` times the back-to-back stages of a device pipeline: a
span per stage, plus ``args.device_ms`` from CUDA events recorded at
the stage marks without a wait and read (:func:`resolve_device_times`)
once they have completed.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["Tracer", "Span", "NOOP_SPAN", "Stages", "span", "enabled",
           "enable", "disable", "get_tracer", "resolve_device_times"]


class _NoopSpan:
    """The disabled-tracer span: one shared instance, every method a
    no-op returning fast.  Reentrant (``__enter__`` just returns self),
    so one module-level object serves arbitrarily nested ``with``
    blocks with zero allocations."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def sync(self, *values: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


def _cuda_devices(values) -> List[torch.device]:
    """The CUDA devices of the tensors in ``values`` (nested lists,
    tuples and dict values are walked), each once."""
    found: List[torch.device] = []
    todo = list(values)
    while todo:
        v = todo.pop()
        if isinstance(v, (list, tuple)):
            todo.extend(v)
        elif isinstance(v, dict):
            todo.extend(v.values())
        elif isinstance(v, torch.Tensor) and v.is_cuda \
                and v.device not in found:
            found.append(v.device)
    return found


class Span:
    """One live span.  Use as a context manager; at ``__exit__`` it
    optionally waits for the registered tensors' devices (so the
    recorded duration covers the device work the stage enqueued) and
    records one complete event."""

    __slots__ = ("_tracer", "name", "attrs", "_sync", "_t0", "_range",
                 "_event")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]],
                 sync: Optional[Any] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._sync = [sync] if sync is not None else []
        self._t0 = 0.0
        self._range = None    # the profiler range, while one records
        self._event = None    # the recorded event, once closed

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (rendered as Chrome trace args); after the
        close they go to the recorded event too."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        if self._event is not None:
            self._event["args"] = self.attrs
        return self

    def sync(self, *values: Any) -> "Span":
        """Register tensors whose device work the span waits for at
        close."""
        self._sync.extend(values)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._sync and exc_type is None:
            # the tracer's single intended block point: enabled-mode
            # spans time device work by waiting at stage close -- that
            # wait is the feature, and it never runs when tracing is
            # off (span() returns NOOP_SPAN then)
            for dev in _cuda_devices(self._sync):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ev.synchronize()  # grit-lint: disable=hot-path-sync -- enabled-mode span close is the stage's intended block point; tracing-off serving never reaches this line
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._event = self._tracer._pop(self, self._t0, t1,
                                        error=exc_type is not None)


class Tracer:
    """Records complete-span events (thread-safe append)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.t0 = time.perf_counter()
        self.events: List[Dict[str, Any]] = []
        # spans timed by CUDA events whose closing event may not have
        # completed yet: (span, opening event, closing event)
        self._device: List[Tuple[Span, Any, Any]] = []

    # -- span plumbing -----------------------------------------------------

    def _stack(self) -> List["Span"]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span, t0: float, t1: float,
             error: bool = False) -> Dict[str, Any]:
        stack = self._stack()
        depth = len(stack) - 1
        if stack and stack[-1] is span:
            stack.pop()
        if error:
            span.attrs = span.attrs or {}
            span.attrs["error"] = True
        ev: Dict[str, Any] = {
            "name": span.name,
            "ph": "X",
            "ts": (t0 - self.t0) * 1e6,          # us, perf_counter base
            "dur": (t1 - t0) * 1e6,
            "pid": 0,
            "tid": threading.get_ident() % 100_000,
            "depth": depth,
        }
        if span.attrs:
            ev["args"] = span.attrs
        with self._lock:
            self.events.append(ev)
        return ev

    def _time_device(self, span: Span, start, end) -> None:
        with self._lock:
            self._device.append((span, start, end))

    def resolve_device_times(self) -> None:
        """Give ``args.device_ms`` to every span timed by CUDA events
        whose closing event has completed; the others wait for a later
        call.  Never waits."""
        with self._lock:
            todo, self._device = self._device, []
        for sp, start, end in todo:
            if end.query():
                sp.set(device_ms=start.elapsed_time(end))
            else:
                self._time_device(sp, start, end)

    # -- public ------------------------------------------------------------

    def span(self, name: str, sync: Optional[Any] = None,
             **attrs: Any) -> Span:
        return Span(self, name, attrs or None, sync=sync)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self._device.clear()
        self.t0 = time.perf_counter()

    def snapshot_events(self) -> List[Dict[str, Any]]:
        self.resolve_device_times()
        with self._lock:
            return [dict(e) for e in self.events]


# --------------------------------------------------------------------------
# module-level switch
# --------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enable(clear: bool = False) -> Tracer:
    """Turn tracing on (idempotent); returns the live tracer."""
    global _TRACER
    if _TRACER is None:
        _TRACER = Tracer()
    elif clear:
        _TRACER.clear()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Turn tracing off; returns the (frozen) tracer for export."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def span(name: str, sync: Optional[Any] = None, **attrs: Any):
    """A span under the process tracer -- or the shared no-op when
    tracing is off (the hot-path fast exit: one global read)."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return Span(t, name, attrs or None, sync=sync)


def resolve_device_times() -> None:
    """:meth:`Tracer.resolve_device_times` of the process tracer (no-op
    when tracing is off).  Call it after a host read that waited for
    the stream: every event recorded before it has completed."""
    t = _TRACER
    if t is not None:
        t.resolve_device_times()


def _device_event(device: torch.device):
    """A timing CUDA event recorded now, without a wait, on the current
    stream of ``device``; None when ``device`` is not a CUDA device."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Stages:
    """Back-to-back spans over the stages of one pipeline run, named
    ``<prefix>.<stage>`` for ``stages`` in their fixed order:
    :meth:`start` opens the first stage's span, each :meth:`mark` closes
    the open one and opens the next.  The host interval of a stage is
    the host's time in it; ``args.device_ms`` is, on a CUDA device, the
    time between the events recorded at its opening and closing marks
    (resolved later, see :func:`resolve_device_times`), and elsewhere
    the host interval.  While tracing is off nothing is recorded: no
    span, no event."""

    def __init__(self, prefix: str, stages: Sequence[str]):
        self.names = tuple(f"{prefix}.{s}" for s in stages)
        self._open: Optional[Tuple[Span, Any, int]] = None

    def start(self, device: torch.device) -> None:
        if _TRACER is not None:
            self._begin(0, device, _device_event(device))

    def mark(self, device: torch.device) -> None:
        if self._open is None:
            return
        sp, start, i = self._open
        self._open = None
        end = _device_event(device)
        sp.__exit__(None, None, None)
        if end is None:
            sp.set(device_ms=sp._event["dur"] * 1e-3)
        else:
            sp._tracer._time_device(sp, start, end)
        if i + 1 < len(self.names):
            self._begin(i + 1, device, end)

    def set(self, **attrs: Any) -> None:
        """Attach attributes to the open stage's span (nothing while
        tracing is off)."""
        if self._open is not None:
            self._open[0].set(**attrs)

    def close(self) -> None:
        """End a stage span that an error left open (recorded as an
        error)."""
        if self._open is not None:
            sp = self._open[0]
            self._open = None
            sp.__exit__(RuntimeError, None, None)

    def _begin(self, i: int, device: torch.device, start) -> None:
        t = _TRACER
        if t is None:
            return
        sp = Span(t, self.names[i], None)
        sp.__enter__()
        self._open = (sp, start, i)
