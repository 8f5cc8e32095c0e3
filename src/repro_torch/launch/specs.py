"""Model configuration for a launcher: ``model_cfg_for(arch, smoke)``."""

from __future__ import annotations

from ..configs import canonical, get_config
from ..models.config import LMConfig

# the reference's per-arch ``param_dtype`` override (``ARCH_TRAIN`` of
# ``repro.launch.specs``, memory-driven); its optimizer and microbatch
# knobs belong to the training slice (ROADMAP A17)
ARCH_PARAM_DTYPE = {"arctic_480b": "bfloat16"}


def model_cfg_for(arch: str, *, smoke: bool = False) -> LMConfig:
    """The arch's config, with its ``param_dtype`` override outside the
    smoke configs (as the reference's)."""
    cfg = get_config(arch, smoke=smoke)
    dtype = ARCH_PARAM_DTYPE.get(canonical(arch))
    if dtype is not None and not smoke:
        cfg = cfg.with_overrides(param_dtype=dtype)
    return cfg
