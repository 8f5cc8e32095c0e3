"""Model configuration for a launcher: ``model_cfg_for(arch, smoke)``."""

from __future__ import annotations

from ..configs import get_config
from ..models.config import LMConfig


def model_cfg_for(arch: str, *, smoke: bool = False) -> LMConfig:
    """The arch's config.  The reference's one per-arch override (arctic's
    bfloat16 ``param_dtype``) comes with the moe family (ROADMAP A17): no
    ported arch has one."""
    return get_config(arch, smoke=smoke)
