"""rwkv6-3b -- Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="rwkv6-3b", family="rwkv",
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=8960, vocab_size=65536,
        attn_kind="none", chunk_size=16, ce_chunk=512,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="rwkv6-smoke", family="rwkv",
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=512,
        attn_kind="none", chunk_size=8, ce_chunk=32,
    )
