"""Diagnostics: the :class:`Violation` record and the :class:`Report`.

A violation is one ``file:line:col`` finding of one rule.  Suppression
(via a justified pragma, see ``pragmas.py``) does not delete the
finding -- it stays in the report with ``suppressed=True`` and the
pragma's written reason, so the set of escape hatches in the tree is
itself auditable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding of one rule at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""  # the pragma's justification when suppressed

    def format(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        tag = f"[{self.rule}]"
        if self.suppressed:
            return f"{loc}: {tag} suppressed ({self.reason}): {self.message}"
        return f"{loc}: {tag} {self.message}"


@dataclasses.dataclass
class Report:
    """Every finding of one analysis run, suppressed ones included."""

    violations: List[Violation] = dataclasses.field(default_factory=list)
    files_checked: int = 0

    @property
    def active(self) -> List[Violation]:
        """Unsuppressed findings -- what fails the check."""
        return [v for v in self.violations if not v.suppressed]

    @property
    def suppressed(self) -> List[Violation]:
        """Findings silenced by a justified pragma (reason attached)."""
        return [v for v in self.violations if v.suppressed]

    @property
    def ok(self) -> bool:
        return not self.active

    def counts_by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.active:
            out[v.rule] = out.get(v.rule, 0) + 1
        return out

    def format(self, show_suppressed: bool = False) -> str:
        lines: List[str] = []
        ordered = sorted(self.violations,
                         key=lambda v: (v.path, v.line, v.col, v.rule))
        for v in ordered:
            if v.suppressed and not show_suppressed:
                continue
            lines.append(v.format())
        n_act, n_sup = len(self.active), len(self.suppressed)
        if n_act:
            per_rule = ", ".join(f"{k}: {n}" for k, n in
                                 sorted(self.counts_by_rule().items()))
            lines.append(
                f"{n_act} violation(s) in {self.files_checked} file(s) "
                f"({per_rule}); {n_sup} suppressed")
        else:
            lines.append(
                f"clean: {self.files_checked} file(s), 0 violations "
                f"({n_sup} suppressed by justified pragma)")
        return "\n".join(lines)
