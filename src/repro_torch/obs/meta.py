"""Run provenance: one dict stamped into every benchmark artifact.

A number without its machine is unauditable -- the same ratio on a CPU
runner and on an H100 are different facts, and an H100 set below its
700 W power limit runs slower under load.  :func:`bench_meta` captures
the invariants that make a benchmark row comparable: torch / CUDA
versions, backend + device kind/count, the card's name and power limit
as ``nvidia-smi`` reports them, host platform, an ISO-8601 UTC
timestamp, and the git revision.
"""

from __future__ import annotations

import platform
import subprocess
import sys
from datetime import datetime, timezone
from typing import Any, Dict

import torch

__all__ = ["bench_meta", "git_rev", "power_limit"]


def git_rev() -> str:
    """Short git revision of the working tree ("unknown" outside a
    checkout), with a ``-dirty`` suffix for uncommitted changes."""
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            check=True).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            capture_output=True, text=True, timeout=5,
            check=True).stdout.strip()
        return rev + ("-dirty" if dirty else "")
    except Exception:
        return "unknown"


def power_limit() -> str:
    """The first card's ``name, power.limit`` line as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints it
    ("unknown" where there is no ``nvidia-smi`` or no card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except Exception:
        return "unknown"


def bench_meta() -> Dict[str, Any]:
    """Provenance block for benchmark emitters (JSON-able)."""
    cuda = torch.cuda.is_available()
    return {
        "timestamp": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "git_rev": git_rev(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "power_limit": power_limit(),
    }
