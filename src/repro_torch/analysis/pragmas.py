"""The per-rule pragma escape hatch.

Syntax (one comment, end of the violating line or the line above it)::

    x = f32_thing()  # grit-lint: disable=f64-discipline -- reason here
    # grit-lint: disable=hot-path-sync,recompile-hazard -- shared reason

The reason after ``--`` is *mandatory*: a pragma without one (or naming
an unknown rule) suppresses nothing and is reported under the
``pragma`` meta-rule, so every escape hatch in the tree carries a
written justification the report can surface (``--show-suppressed``).
``disable=all`` suppresses every rule on that line.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Tuple

from .report import Violation

_PRAGMA_RE = re.compile(
    r"#\s*grit-lint:\s*disable=([A-Za-z0-9_,\- ]+?)"
    r"(?:\s+--\s*(.*?))?\s*$")


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One parsed ``# grit-lint: disable=...`` comment."""

    line: int
    rules: FrozenSet[str]
    reason: str

    def covers(self, rule: str) -> bool:
        return rule in self.rules or "all" in self.rules


def parse_pragmas(path: str, lines: List[str],
                  known_rules: FrozenSet[str],
                  ) -> Tuple[Dict[int, Pragma], List[Violation]]:
    """Scan source lines for pragmas.

    Returns ``(pragmas_by_line, malformed)``: well-formed pragmas keyed
    by their 1-based line, and a ``pragma``-rule violation for each
    malformed one (missing reason / unknown rule) -- malformed pragmas
    never suppress anything.
    """
    pragmas: Dict[int, Pragma] = {}
    malformed: List[Violation] = []
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if m is None:
            continue
        names = frozenset(
            p.strip() for p in m.group(1).split(",") if p.strip())
        reason = (m.group(2) or "").strip()
        unknown = sorted(n for n in names
                         if n != "all" and n not in known_rules)
        if not reason:
            malformed.append(Violation(
                rule="pragma", path=path, line=i, col=text.index("#"),
                message="pragma has no justification: write "
                        "'# grit-lint: disable=<rule> -- <reason>' "
                        "(a reasonless pragma suppresses nothing)"))
            continue
        if unknown:
            malformed.append(Violation(
                rule="pragma", path=path, line=i, col=text.index("#"),
                message=f"pragma names unknown rule(s) {unknown}; "
                        "it suppresses nothing"))
            continue
        pragmas[i] = Pragma(line=i, rules=names, reason=reason)
    return pragmas, malformed


def find_suppression(pragmas: Dict[int, Pragma], rule: str,
                     line: int) -> Optional[Pragma]:
    """The pragma covering ``rule`` at ``line``, if any.

    A pragma applies to its own line and to the line directly below it
    (so multi-line statements can carry the comment above them).
    """
    for cand in (pragmas.get(line), pragmas.get(line - 1)):
        if cand is not None and cand.covers(rule):
            return cand
    return None


def apply_pragmas(violations: List[Violation],
                  pragmas: Dict[int, Pragma]) -> List[Violation]:
    """Mark each violation suppressed when a justified pragma covers it."""
    out: List[Violation] = []
    for v in violations:
        p = find_suppression(pragmas, v.rule, v.line)
        if p is None:
            out.append(v)
        else:
            out.append(dataclasses.replace(
                v, suppressed=True, reason=p.reason))
    return out
