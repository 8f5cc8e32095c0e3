"""``repro_torch.obs``: the tracing + metrics plane.

One instrumentation layer for every subsystem -- spans
(``repro_torch.obs.trace``), a process-wide metric registry
(``repro_torch.obs.metrics``), Chrome-trace / JSONL exporters
(``repro_torch.obs.export``) and a text summarizer (``python -m
repro_torch.obs.view``).  Span, counter and gauge names are the
reference's (``repro.obs``), so attribution tables line up across the
two packages.  The short version of the overhead policy:

* tracing **off** (default): ``obs.span(...)`` returns a shared no-op
  -- zero events, zero host syncs, the serving hot path is untouched;
* tracing **on** (``REPRO_OBS=1`` or :func:`enable`): spans wait for
  their registered tensors' devices at close only, counters /
  histograms always record (they are host-side integer adds and never
  sync).

Environment switches (read once at import):

* ``REPRO_OBS=1`` -- enable tracing and the kernel-build counters.
* ``REPRO_OBS_TRACE=<path>`` -- at process exit, export the Chrome
  trace (with the metrics snapshot and ``bench_meta`` provenance)
  there; implies ``REPRO_OBS=1``.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional

from . import export
from .meta import bench_meta, git_rev
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      build_counts, build_hooks_installed, counter, gauge,
                      histogram, install_build_hooks, registry)
from .trace import (NOOP_SPAN, Span, Tracer, disable, enable, enabled,
                    get_tracer, span)

__all__ = [
    "span", "enabled", "enable", "disable", "get_tracer", "Tracer",
    "Span", "NOOP_SPAN",
    "MetricsRegistry", "registry", "counter", "gauge", "histogram",
    "Counter", "Gauge", "Histogram",
    "install_build_hooks", "build_hooks_installed", "build_counts",
    "bench_meta", "git_rev", "export",
    "note_flat_dispatch", "export_chrome",
]


def note_flat_dispatch(stage: str, t_valid: int, bucket: int) -> None:
    """Record one flat ragged gather dispatch (``pairwise_d2_flat`` /
    ``_flat_res``): dispatch count, valid elements, and the elements
    actually shipped -- ``elems / bucket_elems`` is the bucket
    occupancy (1 - padding waste).  Host-side counter adds only: safe
    on the serving hot path."""
    r = registry()
    r.counter(f"kernels.flat.{stage}.dispatches").inc()
    r.counter(f"kernels.flat.{stage}.elems").inc(t_valid)
    r.counter(f"kernels.flat.{stage}.bucket_elems").inc(bucket)


def export_chrome(path: str, reg: Optional[MetricsRegistry] = None,
                  meta: bool = True) -> bool:
    """Export the live tracer's events as a Chrome trace at ``path``
    (with the registry snapshot + provenance).  Returns False when
    tracing was never enabled (nothing to export)."""
    t = get_tracer()
    if t is None:
        return False
    export.write_chrome_trace(
        path, t.snapshot_events(),
        metrics=(reg or registry()).snapshot(),
        meta=bench_meta() if meta else None)
    return True


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off")


_TRACE_OUT = os.environ.get("REPRO_OBS_TRACE", "").strip()
if _env_truthy("REPRO_OBS") or _TRACE_OUT:
    enable()
    install_build_hooks()
    if _TRACE_OUT:
        atexit.register(export_chrome, _TRACE_OUT)
