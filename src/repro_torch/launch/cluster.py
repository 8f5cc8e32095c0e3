"""Fault tolerance & elasticity runtime for the training drivers.

The reference's (``repro.launch.cluster``) over the port's
``train.checkpoint``: the same interfaces, with the failure paths
exercised by tests via fault injection.

Components
----------
* ``Heartbeat``       -- per-host liveness file (atomic mtime bump) +
                         cluster-wide staleness scan: the straggler /
                         dead-node detector a coordinator polls.
* ``StepGuard``       -- wraps the train step with (a) a wall-clock
                         budget derived from a trailing median (straggler
                         mitigation: a step exceeding ``factor`` x median
                         raises ``StragglerDetected`` so the driver can
                         checkpoint-and-rejoin), (b) retry-with-restore
                         on transient failure.
* ``run_resilient``   -- the driver loop: periodic async checkpoints,
                         crash -> restore from latest -> continue;
                         resumable on a different mesh shape (elastic)
                         because checkpoints are placement-agnostic
                         (a restore lands on the device of the state
                         it replaces).

``StepGuard`` times a step with the host clock, as the reference does: on
the card a step that returns before its kernels finish is timed by
whatever waits for them next (the loop's metrics read, a checkpoint's
host copy).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, Optional

from ..train import checkpoint as ckpt
from ..train.tree import flatten


class StragglerDetected(RuntimeError):
    pass


class Heartbeat:
    def __init__(self, run_dir: str, host_id: int):
        self.path = os.path.join(run_dir, f"heartbeat_{host_id:05d}")
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)

    def beat(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, self.path)

    def stale_hosts(self, timeout_s: float) -> list:
        now = time.time()
        out = []
        for name in os.listdir(self.run_dir):
            if not name.startswith("heartbeat_"):
                continue
            p = os.path.join(self.run_dir, name)
            try:
                age = now - os.stat(p).st_mtime
            except FileNotFoundError:
                continue
            if age > timeout_s:
                out.append(int(name.split("_")[1]))
        return sorted(out)


@dataclasses.dataclass
class StepGuard:
    """Straggler + transient-failure guard around one train step."""
    factor: float = 5.0
    window: int = 32
    min_samples: int = 5
    max_retries: int = 2
    floor_s: float = 0.05    # ignore jitter below this absolute duration

    def __post_init__(self):
        self._times: deque = deque(maxlen=self.window)

    def median(self) -> Optional[float]:
        if len(self._times) < self.min_samples:
            return None
        s = sorted(self._times)
        return s[len(s) // 2]

    def __call__(self, step_fn: Callable, *args):
        med = self.median()
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            t0 = time.time()
            try:
                out = step_fn(*args)
                dt = time.time() - t0
                self._times.append(dt)
                if med is not None and dt > self.factor * med \
                        and dt > self.floor_s:
                    raise StragglerDetected(
                        f"step took {dt:.3f}s vs median {med:.3f}s")
                return out
            except StragglerDetected:
                raise
            except Exception as e:          # transient failure -> retry
                last_exc = e
        raise last_exc


def run_resilient(state, step_fn, next_batch: Callable, *,
                  ckpt_dir: str, num_steps: int,
                  ckpt_every: int = 50, keep: int = 3,
                  guard: Optional[StepGuard] = None,
                  pipeline_state: Optional[Callable] = None,
                  on_metrics: Optional[Callable] = None,
                  inject_failure: Optional[Callable] = None,
                  on_restore: Optional[Callable] = None):
    """Checkpointed training loop; crashes restore from the latest save.

    ``inject_failure(step) -> Exception | None`` is the test hook.
    ``on_restore(extra)``, when given, receives the restored checkpoint's
    ``extra`` after a crash-restore (so a driver can rewind its data
    stream to the saved cursor; without it the stream runs on, as in the
    reference).  Returns (final state, steps actually run).
    """
    guard = guard or StepGuard()
    os.makedirs(ckpt_dir, exist_ok=True)
    start = int(state["step"])
    pending = None
    i = start
    while i < num_steps:
        batch = next_batch()
        try:
            if inject_failure is not None:
                exc = inject_failure(i)
                if exc is not None:
                    raise exc
            state, metrics = guard(step_fn, state, batch)
        except StragglerDetected:
            # checkpoint immediately; a coordinator would reschedule us
            if pending is not None:
                pending.join()           # avoid two concurrent writers
                pending = None
            ckpt.save(ckpt_dir, i, state,
                      extra=pipeline_state() if pipeline_state else {})
            raise
        except Exception:
            # transient hard failure: restore from latest and continue
            if pending is not None:
                pending.join()           # let the in-flight save commit
                pending = None
            step_no = ckpt.latest_step(ckpt_dir)
            if step_no is None:
                raise
            state, extra = ckpt.restore(ckpt_dir, state,
                                        device=flatten(state)[0][0].device)
            if on_restore is not None:
                on_restore(extra)
            i = int(state["step"])
            continue
        i += 1
        if on_metrics is not None:
            on_metrics(i, metrics)
        if i % ckpt_every == 0 or i == num_steps:
            if pending is not None:
                pending.join()
            pending = ckpt.save_async(
                ckpt_dir, i, state,
                extra=pipeline_state() if pipeline_state else {})
            ckpt.gc_checkpoints(ckpt_dir, keep=keep)
    if pending is not None:
        pending.join()
    return state, i - start
