"""zamba2-2.7b -- Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000 ssm_state=64.
The shared transformer block (one parameter set) is applied every
``shared_attn_every`` Mamba2 layers.
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        head_dim=80, d_ff=10240, vocab_size=32000,
        ssm_state=64, expand=2, conv_width=4, shared_attn_every=6,
        chunk_size=256,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, ce_chunk=32,
        ssm_state=16, ssm_heads=2, expand=2, conv_width=4,
        shared_attn_every=2, chunk_size=8,
    )
