"""Trace exporters: Chrome trace-event JSON (Perfetto-loadable) and a
JSONL event stream, plus the loader the viewer shares.

The Chrome format is the profiling lingua franca: ``{"traceEvents":
[...complete events...]}`` with microsecond ``ts``/``dur`` opens
directly in ``ui.perfetto.dev`` / ``chrome://tracing``.  The repo's
metrics snapshot and provenance (``bench_meta``) ride along under
``otherData`` -- ignored by the UIs, read by ``repro_torch.obs.view``.

JSONL is the stream form: one JSON object per line, span events
as-recorded, with a trailing ``{"kind": "metrics"}`` line carrying the
registry snapshot -- greppable and append-friendly for long serving
runs.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["chrome_trace", "write_chrome_trace", "write_jsonl",
           "load_trace"]


def chrome_trace(events: List[Dict[str, Any]],
                 metrics: Optional[Dict[str, Any]] = None,
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render recorded span events as a Chrome trace-event document."""
    te = []
    for e in events:
        ev = {
            "name": e["name"],
            "cat": e.get("cat", "repro"),
            "ph": e.get("ph", "X"),
            "ts": e["ts"],
            "dur": e.get("dur", 0.0),
            "pid": e.get("pid", 0),
            "tid": e.get("tid", 0),
        }
        if e.get("args"):
            ev["args"] = e["args"]
        te.append(ev)
    doc: Dict[str, Any] = {
        "traceEvents": te,
        "displayTimeUnit": "ms",
    }
    other: Dict[str, Any] = {}
    if meta:
        other["meta"] = meta
    if metrics:
        other["metrics"] = metrics
    if other:
        doc["otherData"] = other
    return doc


def write_chrome_trace(path: str, events: List[Dict[str, Any]],
                       metrics: Optional[Dict[str, Any]] = None,
                       meta: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(events, metrics=metrics, meta=meta), f,
                  indent=1)
        f.write("\n")


def write_jsonl(path: str, events: List[Dict[str, Any]],
                metrics: Optional[Dict[str, Any]] = None,
                meta: Optional[Dict[str, Any]] = None) -> None:
    with open(path, "w") as f:
        if meta:
            f.write(json.dumps({"kind": "meta", **meta}) + "\n")
        for e in events:
            f.write(json.dumps({"kind": "span", **e}) + "\n")
        if metrics:
            f.write(json.dumps({"kind": "metrics",
                                "metrics": metrics}) + "\n")


def load_trace(path: str) -> Tuple[List[Dict[str, Any]],
                                   Dict[str, Any], Dict[str, Any]]:
    """Load either export format -> (span events, metrics, meta).

    Chrome documents are detected by their ``traceEvents`` key; JSONL
    by one JSON object per line with a ``kind`` tag.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and "traceEvents" in doc:
        other = doc.get("otherData", {})
        events = [e for e in doc["traceEvents"]
                  if e.get("ph", "X") == "X"]
        return events, other.get("metrics", {}), other.get("meta", {})
    events, metrics, meta = [], {}, {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        kind = rec.pop("kind", "span")
        if kind == "span":
            events.append(rec)
        elif kind == "metrics":
            metrics = rec.get("metrics", rec)
        elif kind == "meta":
            meta = rec
    return events, metrics, meta
