"""Arch configs (one module per architecture the port runs) + shape sets."""

from .registry import (ARCHS, canonical, get_config, list_archs,
                       long_500k_supported)
from .shapes import SHAPES, ShapeCfg, get_shape
