"""Model configuration schema shared by the whole zoo.

A copy of the reference's schema (``LMConfig``, ``MoECfg``,
``num_params``), field for field, so a configuration means the same in
both packages.  ``LMConfig`` is a frozen (hashable) dataclass.  One
instance fully determines parameter shapes and the forward graph for
every assigned architecture family:

  dense   -- llama-style decoder-only (qwen2, qwen1.5, stablelm, gemma2)
  moe     -- dense + mixture-of-experts FFN (mixtral, arctic)
  rwkv    -- RWKV6 "Finch" attention-free (rwkv6-3b)
  hybrid  -- Mamba2 backbone + shared attention block (zamba2)
  encdec  -- whisper-style encoder-decoder (audio frontend stubbed)
  vlm     -- ViT-frontend-stubbed decoder-only (internvl2)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    capacity_factor: float = 1.25
    dense_residual: bool = False    # arctic: dense MLP in parallel with MoE
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # dense | moe | rwkv | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # ---- attention ----
    attn_kind: str = "full"         # full | swa | local_global | none
    window: int = 4096
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 1e6
    rope_fraction: float = 1.0      # stablelm: partial rotary
    attn_impl: str = "auto"         # auto | direct | rect | tri | banded
    attn_chunk: int = 1024          # kv/q block for blocked attention

    # ---- block / mlp ----
    norm: str = "rms"               # rms | layer
    act: str = "silu"               # silu | gelu
    mlp_kind: str = "glu"           # glu | plain
    tie_embeddings: bool = False
    scale_embed: bool = False       # gemma: embed * sqrt(d_model)
    moe: Optional[MoECfg] = None

    # ---- ssm / rwkv ----
    ssm_state: int = 64
    ssm_heads: int = 0              # mamba2 value heads (0 -> derived)
    conv_width: int = 4
    expand: int = 2                 # mamba2 inner expansion
    shared_attn_every: int = 6      # zamba2: shared attn block period
    chunk_size: int = 256           # ssm / rwkv chunkwise scan length

    # ---- encoder-decoder ----
    enc_layers: int = 0
    enc_seq: int = 1500             # whisper: audio frame count

    # ---- vlm ----
    num_patches: int = 256

    # ---- numerics / compilation ----
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    dtype: str = "bfloat16"
    logit_dtype: str = "float32"    # attention/CE logit *buffer* dtype;
                                    # softmax math stays f32 (fused)
    remat: bool = True
    scan_layers: bool = True
    ce_chunk: int = 512             # sequence chunk for the CE loss
    use_flash_kernel: bool = False  # prefill attention through the
                                    # hand-written flash kernel

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return self.d_inner // 64   # mamba2 default head_dim 64

    def with_overrides(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


def num_params(cfg: LMConfig) -> int:
    """Total parameter count (exact, mirrors init_params)."""
    d, ff, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def attn_params() -> int:
        p = d * (H * Dh) + 2 * d * (KV * Dh) + (H * Dh) * d
        if cfg.qkv_bias:
            p += H * Dh + 2 * KV * Dh
        return p

    def mlp_params(hidden: int) -> int:
        if cfg.mlp_kind == "glu":
            return 3 * d * hidden
        return 2 * d * hidden

    total = V * d                      # embedding
    if not cfg.tie_embeddings:
        total += V * d                 # output head

    if cfg.family in ("dense", "vlm"):
        per = attn_params() + mlp_params(ff) + 2 * d
        total += cfg.num_layers * per + d
    elif cfg.family == "moe":
        m = cfg.moe
        per = attn_params() + 2 * d + d * m.num_experts \
            + m.num_experts * mlp_params(m.d_ff)
        if m.dense_residual:
            per += mlp_params(ff)
        total += cfg.num_layers * per + d
    elif cfg.family == "rwkv":
        # time-mix: r,k,v,g,o (5 d*d) + decay lora + mix params + ln
        per = 5 * d * d + 2 * (d * 64 + 64 * d) + 6 * d + 2 * d + 2 * d
        # channel-mix: W_k d*ff, W_v ff*d, W_r d*d
        per += d * ff + ff * d + d * d + 2 * d
        total += cfg.num_layers * per + d
    elif cfg.family == "hybrid":
        di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        per = d * (2 * di + 2 * ns + nh) + cfg.conv_width * (di + 2 * ns) \
            + nh + nh + di * d + 2 * d + mlp_params(ff)
        total += cfg.num_layers * per
        total += attn_params() + 2 * d + d   # one shared attention block
    elif cfg.family == "encdec":
        enc_per = attn_params() + mlp_params(ff) + 2 * d
        dec_per = 2 * attn_params() + mlp_params(ff) + 3 * d
        total += cfg.enc_layers * enc_per + cfg.num_layers * dec_per + 2 * d
        total += cfg.enc_seq * d           # learned audio positions
    return total
