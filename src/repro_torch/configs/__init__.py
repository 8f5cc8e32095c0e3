"""Arch configs (one module per architecture the port runs)."""

from .registry import ARCHS, canonical, get_config, long_500k_supported
