"""Counted device-to-host reads and per-stage timing.

Every place where the device pipeline needs a value on the host (a
data-dependent trip count, an overflow report) reads it through
:func:`host_read`, which blocks until the device has produced it.
``READS["count"]`` therefore is the number of host synchronisations a
fit made, which the on-card smoke run reports.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

READS: Dict[str, int] = {"count": 0}


def host_read(t: torch.Tensor):
    """``t.tolist()`` (a Python scalar for a 0-d tensor), counted."""
    READS["count"] += 1
    return t.tolist()


def count_read() -> None:
    """Count a host read that a torch call makes by itself (``nonzero``
    returns a tensor whose size the host must learn)."""
    READS["count"] += 1


# Per-stage wall times of the device pipeline.  Off by default: when
# TIMING["on"] is set, every stage boundary waits for the device so the
# seconds between two marks belong to one stage.
TIMING: Dict[str, bool] = {"on": False}
STAGES: Dict[str, float] = {}
_last: Dict[str, float] = {"t": 0.0}


def stage_start(device: torch.device) -> None:
    """Open a timed pipeline run (no-op unless ``TIMING["on"]``)."""
    if TIMING["on"]:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _last["t"] = time.perf_counter()


def stage_mark(name: str, device: torch.device) -> None:
    """Close stage ``name``: add the seconds since the previous mark to
    ``STAGES[name]`` (no-op unless ``TIMING["on"]``)."""
    if TIMING["on"]:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        STAGES[name] = STAGES.get(name, 0.0) + now - _last["t"]
        _last["t"] = now
