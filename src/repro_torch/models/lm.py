"""The LM: init / forward / cache / prefill / decode for every family.

Public surface used by the launcher and the tests:

  init_params(cfg, gen, device)         -> params (nested dicts of tensors)
  count_params(cfg)                     -> exact param count (meta device)
  active_params(cfg)                    -> params touched per token
  encode(cfg, params, frames)           -> whisper's encoder output
  forward(cfg, params, batch, cache)    -> (hidden, new cache, aux)
  loss_fn(cfg, params, batch)           -> (loss, metrics) chunked CE
  init_cache(cfg, batch, max_len, device) -> decode cache
  prefill(cfg, params, batch, cache)    -> (last logits, cache)
  decode_step(cfg, params, tokens, cache) -> (logits, cache)

The parameter tree has the reference's layout (``repro.models.lm``):
``{"embed": [V, d], "blocks": (one dict per block kind of the group
layout, every leaf stacked on a leading group axis), "ln_f": {...}}``
plus ``"head": [d, V]`` without tied embeddings; in the hybrid family
``"shared"``, the one attention block every group applies; in the
encoder-decoder family ``"enc_blocks"`` (the encoder's stack of
``enc_attn`` blocks) and ``"ln_enc"``; so ``convert.lm_params_from_numpy``
carries a reference tree across leaf by leaf.  Batch dict keys: "tokens"
[B, S] int always; "frames" [B, T, d] (whisper's stub frontend: audio
frame embeddings) and "patches" [B, P, d] (internvl2's: patch
embeddings); for ``loss_fn`` "tokens" is [B, S+1] and an optional
"loss_mask" [B, S] weighs the targets.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import tensor_parallel as tp
from .config import LMConfig
from .sharding_ctx import constrain
from .transformer import (block_params, group_layout, init_block_cache,
                          leaves, num_groups, stack_forward, stack_params)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init_params(cfg: LMConfig, gen: Optional[torch.Generator], device) -> dict:
    """Random params drawn from ``gen`` (a generator on ``device``; may be
    None on the ``meta`` device)."""
    pd = L.dtype_of(cfg.param_dtype)
    layout = group_layout(cfg)
    p = {
        "embed": L.normal((cfg.vocab_size, cfg.d_model), gen, device, 0.02,
                          pd),
        "blocks": stack_params(cfg, gen, device, layout, num_groups(cfg)),
        "ln_f": L.norm_params(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), device,
                                 pd)
    if cfg.family == "hybrid":
        p["shared"] = block_params(cfg, "attn:full", gen, device)
    if cfg.family == "encdec":
        p["enc_blocks"] = stack_params(cfg, gen, device, ("enc_attn",),
                                       cfg.enc_layers)
        p["ln_enc"] = L.norm_params(cfg, device)
    return p


def count_params(cfg: LMConfig) -> int:
    """Parameter count of ``init_params`` from shapes alone (nothing is
    allocated: the tree is built on the ``meta`` device)."""
    return sum(t.numel() for t in leaves(init_params(cfg, None, "meta")))


def active_params(cfg: LMConfig) -> int:
    """Params touched per token (MoE: top-k experts only)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = (3 if cfg.mlp_kind == "glu" else 2) * cfg.d_model * m.d_ff
    inactive = cfg.num_layers * (m.num_experts - m.top_k) * per_expert
    return total - inactive


# --------------------------------------------------------------------------
# embedding / head
# --------------------------------------------------------------------------

def embed(cfg: LMConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The token embeddings [B, S, d]; vocab-parallel under tensor
    parallelism where the model axis divides the vocab."""
    ax = tp.active(cfg)
    span = tp.vocab_split(cfg, ax)
    dtype = L.dtype_of(cfg.dtype)
    if span is not None:
        table = tp.take(params["embed"], 0, cfg.vocab_size, *span, ax)
        x = tp.embed_lookup(table, tokens, span[0], dtype, ax)
    else:
        table = tp.whole(params["embed"], 0, cfg.vocab_size, ax)
        x = table[tokens].to(dtype)
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return constrain(x, "btd")


def unembed_weights(cfg: LMConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _local_logits(cfg: LMConfig, params: dict, h: torch.Tensor):
    """(float32 logits, the vocab id of their first column): the whole
    vocab (id 0), or under tensor parallelism the rank's vocab slice of
    a vocab-parallel head (``h`` enters through ``copy_in``; a tied head
    reads the embedding's slice)."""
    ax = tp.active(cfg)
    span = tp.vocab_split(cfg, ax)
    w = unembed_weights(cfg, params)
    if span is not None:
        h = tp.copy_in(h, ax.group)
        w = tp.take(w, -1, cfg.vocab_size, *span, ax)
    else:
        w = tp.whole(w, -1, cfg.vocab_size, ax)
    w = w.to(h.dtype)
    # logit *buffer* in cfg.logit_dtype; softcap math in f32
    logits = (h.to(torch.float32) @ w.to(torch.float32)).to(
        L.dtype_of(cfg.logit_dtype)).to(torch.float32)
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits, 0 if span is None else span[0]


def logits_for(cfg: LMConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """Float32 logits over the whole vocab (a vocab-parallel rank gathers
    the slices)."""
    logits, _ = _local_logits(cfg, params, h)
    if logits.shape[-1] != cfg.vocab_size:
        logits = tp.gather(logits, -1, tp.active(cfg), summed=False)
    return constrain(logits, "btv")


# --------------------------------------------------------------------------
# forward (prefill trunk)
# --------------------------------------------------------------------------

def _frontend(cfg: LMConfig, params: dict, batch: dict) -> torch.Tensor:
    """Token (+ stub modality) embedding -> [B, S_total, d]: the vlm's
    patches, cast to the activation dtype, go ahead of the tokens."""
    x = embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def encode(cfg: LMConfig, params: dict, frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over (stub) audio frame embeddings [B, T, d]."""
    x = frames.to(L.dtype_of(cfg.dtype))
    x, _, _ = stack_forward(cfg, params["enc_blocks"], x, ("enc_attn",))
    return L.apply_norm(cfg, params["ln_enc"], x)


def forward(cfg: LMConfig, params: dict, batch: dict,
            cache: Optional[dict] = None):
    """Trunk forward. Returns (hidden [B, S, d], new_cache, aux), ``aux``
    the MoE layers' summed load-balancing loss (f32; 0 without MoE).
    With "frames" (encdec) the decoder attends to their encoding unless
    the cache holds the cross-attention K / V (``prefill`` fills them)."""
    x = _frontend(cfg, params, batch)
    enc_out = None
    if cfg.family == "encdec" and "frames" in batch:
        enc_out = encode(cfg, params, batch["frames"])
    x, new_cache, aux = stack_forward(
        cfg, params["blocks"], x, group_layout(cfg), cache=cache,
        shared=params.get("shared"), enc_out=enc_out)
    x = L.apply_norm(cfg, params["ln_f"], x)
    return x, new_cache, aux


# --------------------------------------------------------------------------
# loss (chunked CE; never materializes [B, S, V])
# --------------------------------------------------------------------------

def _ce_chunk(cfg: LMConfig, params: dict, h, labels, mask):
    """Summed masked NLL of one sequence chunk, and its target count;
    vocab-parallel on a tensor-parallel rank's logits
    (``tensor_parallel.vocab_parallel_ce``)."""
    ax = tp.active(cfg)
    if tp.vocab_split(cfg, ax) is None:
        logits = logits_for(cfg, params, h)              # [B, C, V] f32
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        logits, lo = _local_logits(cfg, params, h)       # [B, C, V / M]
        lse, tgt = tp.vocab_parallel_ce(logits, labels, lo, ax)
    nll = (lse - tgt) * mask
    return nll.sum(), mask.sum()


def loss_fn(cfg: LMConfig, params: dict, batch: dict):
    """Next-token CE. tokens [B, S+1]; optional loss_mask [B, S].

    The sequence goes through the head in chunks of ``cfg.ce_chunk``
    (one chunk when it does not divide S), summed in order as the
    reference's scan sums them; under grad each chunk runs under
    ``torch.utils.checkpoint``, so the backward pass recomputes its
    logits and no [B, S, V] tensor exists.  The vlm's loss reads the text
    positions only.  Returns (ce + aux, {"ce", "aux", "tokens"})."""
    tokens = batch["tokens"].to(torch.int64)
    labels = tokens[:, 1:]
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32,
                       device=tokens.device) if mask is None
            else mask.to(torch.float32))
    h, _, aux = forward(cfg, params, {**batch, "tokens": tokens[:, :-1]})
    if cfg.family == "vlm" and "patches" in batch:
        h = h[:, batch["patches"].shape[1]:]             # text positions only
    S = h.shape[1]
    C = min(cfg.ce_chunk, S)
    if not (S % C == 0 and S > C):
        C = S
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, C):
        args = (cfg, params, h[:, c:c + C], labels[:, c:c + C],
                mask[:, c:c + C])
        s, n = (checkpoint(_ce_chunk, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _ce_chunk(*args))
        tot, cnt = tot + s, cnt + n
    loss = tot / torch.clamp_min(cnt, 1.0)
    return loss + aux, {"ce": loss, "aux": aux, "tokens": cnt}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int, device) -> dict:
    """Zeroed caches, one per block kind of the layout with a leading
    group axis (KV for attention, one full-length KV per shared-attention
    application, and per decoder layer of encdec the cross-attention K / V
    of ``enc_seq`` frames; the recurrent states of rwkv / mamba), and the
    shared position ``pos`` (a Python int).  A vlm prefill takes
    ``num_patches`` positions ahead of the prompt."""
    dtype = L.dtype_of(cfg.dtype)
    G = num_groups(cfg)
    return {"pos": 0,
            "slots": tuple(init_block_cache(cfg, kind, batch, max_len, dtype,
                                            device, lead=(G,))
                           for kind in group_layout(cfg))}


def prefill(cfg: LMConfig, params: dict, batch: dict, cache: dict):
    """Run the prompt through the trunk, filling the cache (in place);
    encdec first encodes ``batch["frames"]`` into the cross-attention K / V.

    Returns (logits of the last position [B, V], cache).
    """
    if cfg.family == "encdec":
        cache = _fill_cross_kv(cfg, params, batch["frames"], cache)
        batch = {k: v for k, v in batch.items() if k != "frames"}
    h, cache, _ = forward(cfg, params, batch, cache=cache)
    logits = logits_for(cfg, params, h[:, -1:])[:, 0]
    return logits, cache


def _fill_cross_kv(cfg: LMConfig, params: dict, frames: torch.Tensor,
                   cache: dict) -> dict:
    """Encode ``frames`` and write every decoder layer's cross-attention
    K / V into the cache (in place): one product over the group axis for
    each of K and V (the reference maps over the groups).  Under tensor
    parallelism the cache holds the rank's KV heads (their columns of
    ``wk`` / ``wv``), or every KV head; with an ``"xseq"`` entry (a
    ``tensor_parallel.SeqShard``) the rank's shard of the frames."""
    enc_out = encode(cfg, params, frames)                  # [B, T, d]
    B, T, _ = enc_out.shape
    p, slot = params["blocks"][0]["xattn"], cache["slots"][0]
    ax = tp.active(cfg)
    heads = tp.attn_heads(cfg, ax)
    KV = slot["xk"].shape[2]
    p = tp.attn_weights(cfg, {"wk": p["wk"], "wv": p["wv"]}, ax, heads,
                        all_kv=KV == cfg.num_kv_heads)
    seq = slot.get("xseq")
    lo, hi = (0, T) if seq is None else seq.span(slot["xk"].shape[3])
    for name, w in (("xk", p["wk"]), ("xv", p["wv"])):
        y = torch.matmul(enc_out, w.to(enc_out.dtype)[:, None])  # [G, B, T, .]
        slot[name].copy_(y.reshape(-1, B, T, KV, cfg.head_dim)
                         .transpose(2, 3)[:, :, :, lo:hi])
    return cache


def decode_step(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                cache: dict):
    """One decode step. tokens [B] -> (logits [B, V], new cache)."""
    h, cache, _ = forward(cfg, params, {"tokens": tokens[:, None]},
                          cache=cache)
    logits = logits_for(cfg, params, h)[:, 0]
    return logits, cache
