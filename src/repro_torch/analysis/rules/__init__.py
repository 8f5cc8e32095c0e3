"""Built-in invariant rules.

Importing this package registers every rule with
``repro_torch.analysis.registry`` (the registry defers this import,
mirroring the engine registry's idiom).
"""

from __future__ import annotations

from . import donation, hostsync, precision, recompile, sentinel

__all__ = ["donation", "hostsync", "precision", "recompile", "sentinel"]
