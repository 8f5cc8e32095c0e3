"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
LayerNorm + partial rotary (25%), stablelm-2 style.
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        head_dim=80, d_ff=6912, vocab_size=50304,
        norm="layer", rope_fraction=0.25, rope_theta=1e4,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="stablelm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, ce_chunk=32,
        norm="layer", rope_fraction=0.25, rope_theta=1e4,
    )
