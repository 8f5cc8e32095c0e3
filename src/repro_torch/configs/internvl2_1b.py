"""internvl2-1b -- InternViT frontend (stubbed) + Qwen2-0.5B LM backbone
[arXiv:2404.16821; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
``input_specs`` feeds precomputed patch embeddings [B, 256, d].
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="internvl2-1b", family="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151655,
        qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
        num_patches=256, ce_chunk=256,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512, ce_chunk=32,
        qkv_bias=True, tie_embeddings=True, num_patches=8,
    )
