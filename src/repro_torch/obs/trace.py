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
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["Tracer", "Span", "NOOP_SPAN", "span", "enabled", "enable",
           "disable", "get_tracer"]


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

    __slots__ = ("_tracer", "name", "attrs", "_sync", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]],
                 sync: Optional[Any] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._sync = [sync] if sync is not None else []
        self._t0 = 0.0

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes mid-span (rendered as Chrome trace args)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def sync(self, *values: Any) -> "Span":
        """Register tensors whose device work the span waits for at
        close."""
        self._sync.extend(values)
        return self

    def __enter__(self) -> "Span":
        self._tracer._push(self)
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
        self._tracer._pop(self, self._t0, t1, error=exc_type is not None)


class Tracer:
    """Records complete-span events (thread-safe append)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.t0 = time.perf_counter()
        self.events: List[Dict[str, Any]] = []

    # -- span plumbing -----------------------------------------------------

    def _stack(self) -> List["Span"]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span, t0: float, t1: float,
             error: bool = False) -> None:
        stack = self._stack()
        depth = len(stack) - 1
        if stack and stack[-1] is span:
            stack.pop()
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
        if error:
            ev.setdefault("args", {})["error"] = True
        with self._lock:
            self.events.append(ev)

    # -- public ------------------------------------------------------------

    def span(self, name: str, sync: Optional[Any] = None,
             **attrs: Any) -> Span:
        return Span(self, name, attrs or None, sync=sync)

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
        self.t0 = time.perf_counter()

    def snapshot_events(self) -> List[Dict[str, Any]]:
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
