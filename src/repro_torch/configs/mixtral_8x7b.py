"""mixtral-8x7b -- 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) per-expert d_ff=14336 vocab=32000.
"""

from repro_torch.models.config import LMConfig, MoECfg


def config() -> LMConfig:
    return LMConfig(
        name="mixtral-8x7b", family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=14336, vocab_size=32000,
        attn_kind="swa", window=4096, rope_theta=1e6,
        moe=MoECfg(num_experts=8, top_k=2, d_ff=14336),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="mixtral-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        attn_kind="swa", window=16, attn_chunk=16, ce_chunk=32,
        moe=MoECfg(num_experts=4, top_k=2, d_ff=128),
    )
