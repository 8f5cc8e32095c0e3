"""``repro_torch.analysis``: AST-based invariant linter for the port.

The port's serving path is fast because it layers *conventions* on top
of PyTorch that PyTorch itself cannot enforce: storage shared by two
bindings must not be read through a stale alias, float32 may only decide
provably-certain cases (the guard-band contract -- float64 stays the
reference), kernel operands must route through pow2 bucketing so the
set of launch shapes converges, the hot loop must not wait on the card
outside its intended block points, and reductions over padded buffers
must fold a validity mask first.  Nothing but reviewer vigilance stops
a future change from violating these in a way the differential tests
only catch probabilistically -- so this package turns each convention
into a static rule (stdlib ``ast``, no deps).  The rules keep the names
of the JAX package's rule set (``repro.analysis``), one counterpart
each, so one pragma serves both linters:

* ``donation-aliasing``  -- a read of a binding after an in-place write
  through an alias of its storage, before rebinding
  (``rules/donation.py``);
* ``f64-discipline``     -- float32 casts / mixed-precision comparisons
  in ``core/`` and ``index/`` outside the allowlisted kernel-dispatch
  functions (``rules/precision.py``);
* ``recompile-hazard``   -- kernel operators fed raw data-dependent
  shapes that skip the pow2/bucketing helpers, and tensor-derived values
  in an operator's scalar arguments (``rules/recompile.py``);
* ``hot-path-sync``      -- waits on the card (``.item()``, ``.cpu()``,
  ``.tolist()``, ``torch.nonzero``, ``bool(tensor)``, blocking uploads,
  ...) inside functions reachable from ``ClusterServer.step`` or the
  ``DeviceState`` dispatch stages (``rules/hostsync.py``);
* ``sentinel-mask``      -- raw ``min``/``argmin`` reductions in
  ``kernels/`` without a preceding validity-mask fold
  (``rules/sentinel.py``).

Violations are suppressed line by line with a *justified* pragma::

    risky_expression()  # grit-lint: disable=<rule> -- <reason>

(also honoured on the immediately preceding line).  A pragma without a
reason, or naming an unknown rule, never suppresses -- it is itself
reported under the ``pragma`` meta-rule.  Suppressed violations stay in
the report with their reason, so ``--show-suppressed`` is an audit of
every escape hatch in the tree.  In the port, a ``hot-path-sync``
pragma's reason either names the stage's intended block point or starts
with ``KNOWN:`` -- a wait that is not intended, listed for removal in
ROADMAP.md's host-side gaps.

CLI: ``python -m repro_torch.analysis --check src/repro_torch`` (exit 0
iff no unsuppressed violations); the tier-1 suite runs it over the live
tree, and the on-card smoke run holds ``hot-path-sync`` against
PyTorch's own sync detector on the serving path.
"""

from __future__ import annotations

from .registry import Rule, all_rules, get_rule, register_rule, rule_names
from .report import Report, Violation
from .runner import analyze_paths, collect_py_files

__all__ = [
    "Report",
    "Rule",
    "Violation",
    "all_rules",
    "analyze_paths",
    "collect_py_files",
    "get_rule",
    "register_rule",
    "rule_names",
]
