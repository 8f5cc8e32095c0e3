"""Counted device-to-host reads and per-stage timing.

Every place where the device pipeline needs a value on the host (a
data-dependent trip count, an overflow report) reads it through
:func:`host_read`, which blocks until the device has produced it.
``READS["count"]`` therefore is the number of host synchronisations a
fit made, which the on-card smoke run reports.

The stage marks of the pipeline serve two timings.  ``TIMING`` /
``STAGES`` (off by default) wait for the device at every mark.  With
the tracer on (``repro_torch.obs``), each stage is a span
``device_dbscan.<stage>`` whose ``args.device_ms`` comes from CUDA
events recorded at the marks without a wait.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..obs.trace import Stages

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

#: the pipeline's stages in the order of their marks
STAGE_ORDER = ("grids", "neighbors", "core", "merge", "components",
               "border", "labels")
SPANS = Stages("device_dbscan", STAGE_ORDER)


def stage_start(device: torch.device) -> None:
    """Open a timed pipeline run: ``TIMING``'s clock, and the first
    stage's span while tracing is on."""
    if TIMING["on"]:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _last["t"] = time.perf_counter()
    SPANS.start(device)


def stage_mark(name: str, device: torch.device) -> None:
    """Close stage ``name`` (the next of ``STAGE_ORDER``): add the
    seconds since the previous mark to ``STAGES[name]`` when
    ``TIMING["on"]``, and close its span while tracing is on."""
    if TIMING["on"]:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        STAGES[name] = STAGES.get(name, 0.0) + now - _last["t"]
        _last["t"] = now
    SPANS.mark(device)
