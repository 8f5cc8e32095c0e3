"""whisper-small -- encoder-decoder, conv frontend stubbed
[arXiv:2212.04356; unverified].

12L enc + 12L dec, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
``input_specs`` feeds precomputed audio-frame embeddings [B, 1500, d].
"""

from repro_torch.models.config import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="whisper-small", family="encdec",
        num_layers=12, enc_layers=12, enc_seq=1500,
        d_model=768, num_heads=12, num_kv_heads=12,
        head_dim=64, d_ff=3072, vocab_size=51865,
        norm="layer", act="gelu", mlp_kind="plain", rope_theta=1e4,
    )


def smoke_config() -> LMConfig:
    return LMConfig(
        name="whisper-smoke", family="encdec",
        num_layers=2, enc_layers=2, enc_seq=24,
        d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, ce_chunk=32,
        norm="layer", act="gelu", mlp_kind="plain", rope_theta=1e4,
    )
