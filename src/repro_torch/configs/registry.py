"""Architecture registry: ``--arch <id>`` -> full / smoke LMConfig.

Each arch module defines ``config()`` (the exact published configuration)
and ``smoke_config()`` (same family, reduced: few layers, thin width,
tiny vocab) used by the CPU tests.  The port has the decoder-only
families (dense, moe, hybrid, rwkv); the encoder-decoder and VLM archs of
the reference's registry raise a ``ValueError`` until their families are
ported (ROADMAP A17).
"""

from __future__ import annotations

import importlib

ARCHS = [
    "rwkv6_3b", "mixtral_8x7b", "arctic_480b", "qwen2_1_5b", "stablelm_3b",
    "qwen1_5_0_5b", "gemma2_27b", "zamba2_2_7b",
]

# archs of the reference's registry whose families the port lacks
NOT_YET = ["whisper_small", "internvl2_1b"]


def canonical(arch: str) -> str:
    """Normalize public ids ('qwen2-1.5b', 'mixtral-8x7b') to module names."""
    norm = arch.replace("-", "_").replace(".", "_")
    for a in ARCHS + NOT_YET:
        if norm == a:
            return a
    # tolerate ids like 'qwen1.5-0.5b' -> 'qwen1_5_0_5b'
    return norm


def get_config(arch: str, smoke: bool = False):
    name = canonical(arch)
    if name in NOT_YET:
        raise ValueError(f"arch {arch!r} is not ported yet: the port runs "
                         f"the decoder-only families ({', '.join(ARCHS)}); "
                         f"encoder-decoder and VLM are ROADMAP A17")
    if name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke_config() if smoke else mod.config()


def long_500k_supported(arch: str) -> bool:
    """Sub-quadratic decode: SSM / hybrid / linear-attn / bounded-window."""
    return canonical(arch) in ("rwkv6_3b", "zamba2_2_7b", "mixtral_8x7b")
