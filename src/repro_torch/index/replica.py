"""Read-only replicas: scale predict traffic without touching writes.

One mutable index serializes every reader behind every writer.  The
replication plane splits them: the *primary* absorbs mutations and
appends each top-level batch verbatim to its
:class:`~repro_torch.index.delta.MutationLog`; a :class:`ReplicaIndex`
clones the primary's snapshot once and then *catches up* by replaying
the log from its cursor -- the delta engine is the replay operator, so
no per-row state ships after the initial clone.

**Bit-identity.**  The delta engine is deterministic: identical
starting state + identical mutation batches in identical order ==
identical fitted state, bit for bit.  A caught-up replica therefore
serves ``predict`` (and every read-out) exactly as the primary would
-- same labels, same ids, same float64 decisions -- which is what lets
a serve driver fan read-only traffic across R replicas while the
primary absorbs writes, with no answer drift (pinned by
``tests/test_torch_serve.py``, ``tests/test_torch_sharded_index.py``).
Sharded primaries log their topology ops (split/merge) too: in the
localized regime those re-mint label ids, so a replica must replay
them to stay id-identical, not just partition-identical.

The clone carries no resident device state (a snapshot never holds
one): a replica answers ``mode="device"`` by attaching its own on the
``device`` its caller passes, and every other mode on the host or
through the kernel, as the primary would.

**Staleness.**  ``catch_up()`` replays everything the log still holds;
a replica whose cursor predates the log ``base`` (the primary
truncated replayed history) gets a ``ValueError`` and must re-clone.
``predict`` catches up automatically by default (read-your-writes
against the log); pass ``auto_catch_up=False`` for bounded-staleness
serving where ``catch_up()`` runs on the caller's schedule.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["ReplicaIndex", "make_replicas"]


class ReplicaIndex:
    """Snapshot clone of a primary index + mutation-log catch-up."""

    def __init__(self, primary, *, auto_catch_up: bool = True):
        log = getattr(primary, "mutation_log", None)
        if log is None:
            raise ValueError(
                "primary has no mutation log: call "
                "enable_mutation_log() before creating replicas")
        self._log = log
        # the clone is a restore of a copy of the primary's snapshot:
        # same class, same state, no log of its own (its mutations are
        # replays).  A snapshot's arrays are the primary's own, and a
        # delete updates them in place, so a clone sharing them would see
        # the primary's deletes before replaying them.
        snap = {k: np.array(v, copy=True)
                for k, v in primary.snapshot().items()}
        self.index = type(primary).restore(snap)
        self.cursor = int(primary.ops_applied)
        self.auto_catch_up = bool(auto_catch_up)

    # ------------------------------------------------------------------

    @property
    def d(self) -> int:
        return self.index.d

    @property
    def lag(self) -> int:
        """Ops the primary has applied that this replica has not."""
        return int(self._log.end - self.cursor)

    def catch_up(self) -> int:
        """Replay every log record past the cursor; returns the count.

        Raises ``ValueError`` when the cursor predates the truncated
        log (too stale to catch up -- re-clone from a fresh snapshot).
        """
        n = 0
        for op, payload in self._log.since(self.cursor):
            if op == "insert":
                self.index.insert(payload)
            elif op == "delete":
                self.index.delete(payload)
            elif op == "split":
                self.index.split_shard(int(payload[0]))
            else:
                self.index.merge_shards(int(payload[0]))
            n += 1
        self.cursor += n
        return n

    # ------------------------------------------------------------------
    # read plane (catch-up-then-delegate)
    # ------------------------------------------------------------------

    def predict(self, queries, **kw) -> np.ndarray:
        """Catch up, then the clone's ``predict`` (``device=`` and the
        other keywords pass through)."""
        if self.auto_catch_up:
            self.catch_up()
        return self.index.predict(queries, **kw)

    def predict_async(self, queries, **kw):
        """Dispatch-then-resolve twin of :meth:`predict` (only on
        backends that have one -- the serve driver probes for it);
        ``device=`` passes through."""
        if self.auto_catch_up:
            self.catch_up()
        dispatch = getattr(self.index, "predict_async", None)
        if dispatch is not None:
            return dispatch(queries, **kw)
        out = self.index.predict(queries, **kw)
        return lambda: out

    def labels_arrival(self) -> np.ndarray:
        if self.auto_catch_up:
            self.catch_up()
        return self.index.labels_arrival()

    def core_arrival(self) -> np.ndarray:
        if self.auto_catch_up:
            self.catch_up()
        return self.index.core_arrival()

    # ------------------------------------------------------------------
    # write plane: explicitly absent
    # ------------------------------------------------------------------

    def insert(self, points) -> Dict[str, Any]:
        raise TypeError("ReplicaIndex is read-only: route mutations to "
                        "the primary (replicas catch up from its log)")

    def delete(self, arrival_ids) -> Dict[str, Any]:
        raise TypeError("ReplicaIndex is read-only: route mutations to "
                        "the primary (replicas catch up from its log)")


def make_replicas(primary, r: int, *,
                  auto_catch_up: bool = True) -> "list[ReplicaIndex]":
    """Enable the primary's log and clone ``r`` replicas off it."""
    primary.enable_mutation_log()
    return [ReplicaIndex(primary, auto_catch_up=auto_catch_up)
            for _ in range(int(r))]
