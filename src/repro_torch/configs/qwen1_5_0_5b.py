"""qwen1.5-0.5b -- QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-0.5b", family="dense",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=2816, vocab_size=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e4,
        ce_chunk=256,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, ce_chunk=32,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e4,
    )
