"""Architecture registry: ``--arch <id>`` -> full / smoke LMConfig.

Each arch module defines ``config()`` (the exact published configuration)
and ``smoke_config()`` (same family, reduced: few layers, thin width,
tiny vocab) used by the CPU tests.  The port has every arch of the
reference's registry; an unknown arch raises ``ValueError``.
"""

from __future__ import annotations

import importlib
from typing import List

ARCHS = [
    "rwkv6_3b", "mixtral_8x7b", "arctic_480b", "qwen2_1_5b", "stablelm_3b",
    "qwen1_5_0_5b", "gemma2_27b", "whisper_small", "zamba2_2_7b",
    "internvl2_1b",
]


def canonical(arch: str) -> str:
    """Normalize public ids ('qwen2-1.5b', 'mixtral-8x7b') to module names."""
    norm = arch.replace("-", "_").replace(".", "_")
    for a in ARCHS:
        if norm == a:
            return a
    # tolerate ids like 'qwen1.5-0.5b' -> 'qwen1_5_0_5b'
    return norm


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(arch: str, smoke: bool = False):
    name = canonical(arch)
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke_config() if smoke else mod.config()


def long_500k_supported(arch: str) -> bool:
    """Sub-quadratic decode: SSM / hybrid / linear-attn / bounded-window."""
    return canonical(arch) in ("rwkv6_3b", "zamba2_2_7b", "mixtral_8x7b")
