"""arctic-480b -- 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
"""

from repro_torch.models.config import LMConfig, MoECfg


def config() -> LMConfig:
    return LMConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=4864, vocab_size=32000,
        attn_kind="full",
        moe=MoECfg(num_experts=128, top_k=2, d_ff=4864,
                   dense_residual=True),
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="arctic-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=512, ce_chunk=32,
        attn_kind="full",
        moe=MoECfg(num_experts=8, top_k=2, d_ff=96, dense_residual=True),
    )
