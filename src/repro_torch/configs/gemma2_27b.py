"""gemma2-27b -- local+global alternating attention, logit softcap
[arXiv:2408.00118; hf].

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="gemma2-27b", family="dense",
        num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=36864, vocab_size=256000,
        attn_kind="local_global", window=4096,
        attn_softcap=50.0, logit_softcap=30.0,
        act="gelu", scale_embed=True, rope_theta=1e4,
        ce_chunk=128,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="gemma2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512,
        attn_kind="local_global", window=16, attn_chunk=16,
        attn_softcap=50.0, logit_softcap=30.0,
        act="gelu", scale_embed=True, rope_theta=1e4, ce_chunk=32,
    )
