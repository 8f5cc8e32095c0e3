"""Text summarizer for exported traces: ``python -m
repro_torch.obs.view <trace.json> [--root NAME]``.

Prints the attribution table: per-span-name totals (count / total /
mean / self time), each name's share of the chosen root span's
wall-clock, the coverage of the root by its direct children (how much
of the wall is *attributed* rather than guessed), the kernel-build
counters (``kernels.build.*``: the port's one-off compile and load
costs), and the padding-waste / bucket-occupancy metrics.  Reads both
export formats (Chrome trace JSON and JSONL).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Tuple

from .export import load_trace

__all__ = ["span_aggregates", "attribution", "render", "main"]


def _nest(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Annotate complete events with ``self`` time and ``parent`` name
    by interval containment (per pid/tid lane), the standard Chrome
    trace reconstruction: sort by (ts, -dur), pop the stack while the
    event does not fit inside the top."""
    out = []
    lanes: Dict[Tuple[Any, Any], List[Dict[str, Any]]] = {}
    for e in sorted(events, key=lambda e: (e.get("pid", 0),
                                           e.get("tid", 0),
                                           e["ts"], -e.get("dur", 0.0))):
        lane = lanes.setdefault((e.get("pid", 0), e.get("tid", 0)), [])
        ev = dict(e)
        ev["self"] = ev.get("dur", 0.0)
        ev["parent"] = None
        end = ev["ts"] + ev.get("dur", 0.0)
        eps = 1e-9
        while lane and end > lane[-1]["ts"] + lane[-1]["dur"] + eps:
            lane.pop()
        if lane:
            lane[-1]["self"] -= ev.get("dur", 0.0)
            ev["parent"] = lane[-1]["name"]
        lane.append(ev)
        out.append(ev)
    return out


def span_aggregates(events: List[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    """name -> {count, total_us, mean_us, self_us}."""
    agg: Dict[str, Dict[str, float]] = {}
    for e in _nest(events):
        a = agg.setdefault(e["name"], dict(count=0, total_us=0.0,
                                           self_us=0.0))
        a["count"] += 1
        a["total_us"] += e.get("dur", 0.0)
        a["self_us"] += max(e["self"], 0.0)
    for a in agg.values():
        a["mean_us"] = a["total_us"] / a["count"] if a["count"] else 0.0
    return agg


def attribution(events: List[Dict[str, Any]],
                root: Optional[str] = None) -> Dict[str, Any]:
    """Attribute the root span's wall-clock to its direct children.

    ``root`` defaults to the name of the single longest event.
    Returns ``{root, wall_us, children: {name: us}, accounted_us,
    coverage}`` -- ``coverage`` is the fraction of the root's wall
    spent inside named child spans (the >= 0.9 acceptance bar of the
    traced distributed fit).
    """
    nested = _nest(events)
    if not nested:
        return {"root": root, "wall_us": 0.0, "children": {},
                "accounted_us": 0.0, "coverage": 0.0}
    if root is None:
        root = max(nested, key=lambda e: e.get("dur", 0.0))["name"]
    roots = [e for e in nested if e["name"] == root]
    wall = sum(e.get("dur", 0.0) for e in roots)
    children: Dict[str, float] = {}
    for e in nested:
        if e["parent"] == root:
            children[e["name"]] = children.get(e["name"], 0.0) \
                + e.get("dur", 0.0)
    accounted = sum(children.values())
    return {"root": root, "wall_us": wall, "children": children,
            "accounted_us": accounted,
            "coverage": accounted / wall if wall else 0.0}


def _fmt_ms(us: float) -> str:
    return f"{us / 1e3:10.2f}"


def render(events: List[Dict[str, Any]], metrics: Dict[str, Any],
           meta: Dict[str, Any], root: Optional[str] = None) -> str:
    lines: List[str] = []
    if meta:
        lines.append("meta: " + ", ".join(
            f"{k}={meta[k]}" for k in ("git_rev", "torch", "cuda",
                                       "backend", "device_kind",
                                       "device_count", "power_limit",
                                       "timestamp")
            if k in meta))
    agg = span_aggregates(events)
    if agg:
        lines.append("")
        lines.append(f"{'span':<28}{'count':>7}{'total ms':>11}"
                     f"{'mean ms':>11}{'self ms':>11}")
        for name, a in sorted(agg.items(),
                              key=lambda kv: -kv[1]["total_us"]):
            lines.append(
                f"{name:<28}{a['count']:>7.0f}"
                f"{_fmt_ms(a['total_us'])} {_fmt_ms(a['mean_us'])}"
                f"{_fmt_ms(a['self_us'])}")
        att = attribution(events, root=root)
        if att["wall_us"]:
            lines.append("")
            lines.append(
                f"attribution of {att['root']!r} "
                f"({att['wall_us'] / 1e3:.2f} ms wall):")
            for name, us in sorted(att["children"].items(),
                                   key=lambda kv: -kv[1]):
                lines.append(f"  {name:<26}{_fmt_ms(us)} ms  "
                             f"{100 * us / att['wall_us']:5.1f}%")
            lines.append(f"  accounted: {att['coverage']:.1%} of wall")
    else:
        lines.append("(no span events)")

    compiles = {k: v for k, v in metrics.items()
                if k.startswith("kernels.build.") and isinstance(v, int)}
    if compiles:
        lines.append("")
        lines.append("kernel build counters:")
        for k, v in sorted(compiles.items(),
                           key=lambda kv: -kv[1])[:8]:
            lines.append(f"  {k:<44}{v:>8}")
    waste = {k: v for k, v in metrics.items()
             if "padding_waste" in k or "bucket_elems" in k
             or k.endswith(".elems")}
    if waste:
        lines.append("")
        lines.append("padding / occupancy:")
        for k in sorted(waste):
            v = waste[k]
            val = v["value"] if isinstance(v, dict) and "value" in v \
                else v
            lines.append(f"  {k:<44}{val:>12}")
    others = {k: v for k, v in metrics.items()
              if k not in compiles and k not in waste
              and isinstance(v, int)}
    if others:
        lines.append("")
        lines.append("counters:")
        for k in sorted(others):
            lines.append(f"  {k:<44}{others[k]:>8}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize a repro_torch.obs trace export")
    ap.add_argument("trace", help="Chrome trace JSON or JSONL export")
    ap.add_argument("--root", default=None,
                    help="span name to attribute (default: longest)")
    args = ap.parse_args(argv)
    events, metrics, meta = load_trace(args.trace)
    print(render(events, metrics, meta, root=args.root))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
