"""Load-triggered shard-topology rebalancing.

The 1-D slab topology is chosen once at fit time from the fit-time
point distribution.  Under drift the stream walks away from those
cuts: one slab balloons (its delta-engine mutation cost is
O(n_shard) -- the full-array re-splice dominates) while others empty
out.  The :class:`Rebalancer` closes the loop: the serve driver feeds
it per-shard *load* observations each step (owned routed queries +
mutated rows -- the quantities the slab gauges expose), it smooths
them with an EWMA, and between steps it applies **at most one**
topology op per ``period`` steps:

* the hottest shard's smoothed load exceeds ``hot_factor`` x the
  median  ->  ``index.split_shard(k_hot)``;
* else the coldest *adjacent pair's* combined load is under
  ``cold_factor`` x the *mean*  ->  ``index.merge_shards(k, k+1)``
  (the mean, not the median: cold shards drag the median down with
  them, which would mask exactly the imbalance a merge fixes).

Amortization is the point: a split is O(n_shard) once, the imbalance
it removes is O(n_hot) *every step*.  The period bounds topology churn
so the reconcile cost never competes with serving.  Splits that cannot
make progress (single grid column, < 2 own points) raise ``ValueError``
inside the index; the policy marks that shard unsplittable until the
topology changes again and falls through to the merge arm.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["RebalancePolicy", "Rebalancer"]


@dataclasses.dataclass
class RebalancePolicy:
    """Knobs for load-triggered split/merge of slab shards."""

    period: int = 8           # steps between topology ops (amortization)
    hot_factor: float = 2.0   # split when max load > hot_factor * median
    cold_factor: float = 0.5  # merge when pair load < cold_factor * mean
    min_shards: int = 1
    max_shards: int = 32
    ewma: float = 0.5         # smoothing weight on the newest observation


class Rebalancer:
    """EWMA load tracker + bounded split/merge actuator."""

    def __init__(self, policy: Optional[RebalancePolicy] = None):
        self.policy = policy or RebalancePolicy()
        self.load: Optional[np.ndarray] = None
        self.steps = 0
        # starts at 0 (not -inf): the first op also waits out a full
        # period, so the EWMA has real signal before any topology op
        self.last_op_step = 0
        self.history: List[Dict[str, Any]] = []
        self._unsplittable: set = set()

    # ------------------------------------------------------------------

    def observe(self, loads: Sequence[float]) -> None:
        """Fold one step's per-shard loads into the EWMA.

        A shard-count change (someone else rebalanced, or a restore)
        resets the smoothed state: old per-shard loads do not map onto
        the new topology.
        """
        cur = np.asarray(loads, np.float64)
        self.steps += 1
        if self.load is None or len(self.load) != len(cur):
            self.load = cur.copy()
            self._unsplittable.clear()
            return
        a = self.policy.ewma
        self.load = a * cur + (1.0 - a) * self.load

    def imbalance(self) -> float:
        """max/mean of the smoothed load (1.0 == perfectly balanced)."""
        if self.load is None or len(self.load) == 0:
            return 1.0
        mean = float(self.load.mean())
        return float(self.load.max()) / mean if mean > 0 else 1.0

    # ------------------------------------------------------------------

    def maybe_rebalance(self, index) -> Optional[Dict[str, Any]]:
        """Apply at most one split/merge to ``index``; returns its stats.

        No-op (returns None) while inside the amortization period, when
        there is no load signal yet, or when neither trigger fires.
        """
        p = self.policy
        if self.load is None or len(self.load) != index.num_shards:
            return None
        if self.steps - self.last_op_step < p.period:
            return None
        med = float(np.median(self.load))
        if med <= 0:
            med = float(self.load.mean()) or 1.0

        st = self._try_split(index, med)
        if st is None:
            st = self._try_merge(index)
        if st is not None:
            self.last_op_step = self.steps
            self.load = None  # topology changed: re-learn loads
            self._unsplittable.clear()
            self.history.append(st)
        return st

    def _try_split(self, index, med: float) -> Optional[Dict[str, Any]]:
        p = self.policy
        if index.num_shards >= p.max_shards:
            return None
        assert self.load is not None
        order = np.argsort(self.load)[::-1]
        for k in order:
            k = int(k)
            if self.load[k] <= p.hot_factor * med:
                break  # sorted: nothing hotter remains
            if k in self._unsplittable:
                continue
            try:
                return index.split_shard(k)
            except ValueError:
                self._unsplittable.add(k)
        return None

    def _try_merge(self, index) -> Optional[Dict[str, Any]]:
        p = self.policy
        if index.num_shards <= max(p.min_shards, 1):
            return None
        assert self.load is not None
        pair = self.load[:-1] + self.load[1:]
        k = int(np.argmin(pair))
        # vs the mean, not ``med``: the cold shards themselves drag the
        # median toward zero, masking the imbalance a merge fixes
        if pair[k] >= p.cold_factor * float(self.load.mean()):
            return None
        return index.merge_shards(k, k + 1)
