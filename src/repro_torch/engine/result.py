"""The one result type every clustering engine returns.

``ClusterResult`` is the host-facing contract of :func:`repro_torch.engine.cluster`:
numpy labels in original point order, plus enough provenance (engine
name, overflow trail, per-stage stats) to debug a run without re-running
it.  Device/distributed engines surface their static-cap ``OverflowReport``
here as plain tuples of cap names — an *empty* tuple is the success
criterion; a non-empty one means the result was truncated and must not
be trusted (the adaptive loop retries before ever letting that
escape).

Beyond labels, a result carries what downstream tooling (the fitted
``GritIndex``, serving, diagnostics) would otherwise re-derive:

* ``core`` / ``core_idx`` — core-point flags and their indices;
* ``grid`` — the host :class:`~repro_torch.core.grids.GridIndex` the engine
  built (exact float64 identifiers).  Host engines attach it for free;
  device engines run on float32 identifiers whose cell assignment can
  disagree with the float64 host partition at cell edges, so they leave
  it ``None`` and the ``return_index=True`` path of ``cluster()``
  rebuilds it host-side (one O(n log n) pass) when an index is wanted.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ClusterResult:
    """Clustering of one point set.

    Attributes:
      labels:   [n] int64, original point order; >= 0 cluster id, -1 noise.
      engine:   registry name of the engine that produced the labels.
      n_clusters: number of distinct non-noise labels.
      core:     [n] bool core-point flags, or None if the engine does not
                report them (e.g. the distributed path).
      core_idx: [k] int64 indices of the core points (ascending), or None
                when ``core`` is None.
      grid:     host :class:`~repro_torch.core.grids.GridIndex` (lex-sorted
                non-empty grid identifiers + CSR point ranges + the
                eps/sqrt(d) partition origin), or None for engines that
                never build a float64 host partition (brute, device,
                distributed).
      overflow: names of static caps still overflowing in the *final*
                attempt; empty for host engines and for any result the
                adaptive loop accepted.
      attempts: one dict per adaptive-cap attempt:
                {"caps": {...}, "overflow": (cap names...)}.  Host engines
                leave this empty.
      stats:    engine-specific counters/timings (paper's kappa, distance
                evals, per-stage seconds, ...).
      index:    fitted :class:`~repro_torch.index.GritIndex` when the
                caller asked ``cluster(..., return_index=True)``; None
                otherwise.
    """

    labels: np.ndarray
    engine: str
    n_clusters: int
    core: Optional[np.ndarray] = None
    core_idx: Optional[np.ndarray] = None
    grid: Optional[Any] = None
    overflow: Tuple[str, ...] = ()
    attempts: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    index: Optional[Any] = None

    @classmethod
    def build(cls, labels, engine: str, **kw) -> "ClusterResult":
        labels = np.asarray(labels, np.int64)
        n_clusters = int(len(np.unique(labels[labels >= 0])))
        core = kw.pop("core", None)
        if core is not None:
            core = np.asarray(core, bool)
        if kw.get("core_idx") is None and core is not None:
            kw["core_idx"] = np.flatnonzero(core)
        return cls(labels=labels, engine=engine, n_clusters=n_clusters,
                   core=core, **kw)

    @property
    def noise_count(self) -> int:
        return int((self.labels < 0).sum())
