"""Shared transformer building blocks (pure functions, params as dicts).

Conventions, as in the reference (``repro.models.layers``)
-----------------------------------------------------------
* Parameters are nested dicts of tensors; a *stack* of layers holds the
  same dict with a leading layer axis on every leaf.
* Activations run in ``cfg.dtype`` (bf16 by default); norms/softmax in f32.
* Attention has four plain execution paths (``cfg.attn_impl``):
    direct -- full [Sq, Sk] logits; small sequences.
    rect   -- loop over KV chunks, online softmax. O(chunk) memory but
              rectangular FLOPs (computes masked-out blocks).
    tri    -- static block-pair schedule covering only the causal band.
    banded -- sliding-window band schedule: O(S * window) FLOPs.
  ``auto`` picks direct for short seqs, banded when a window is set, and
  rect otherwise.  With ``use_flash`` (``cfg.use_flash_kernel``) the
  dispatcher sends every call to ``kernels.ops.flash_attention`` instead:
  the hand-written CUDA kernel for tensors on the card, its plain version
  on the CPU.  Decode (one query against the cache) stays plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import tensor_parallel as tp
from .config import LMConfig

NEG_INF = -1e30

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    """The torch dtype of a config dtype name (``"bfloat16"``, ...)."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

# elements drawn at a time, so that the float32 draws of a weight stored
# in another dtype never exist at once (arctic's bfloat16 expert stack of
# one layer is 13.4 G elements); a draw costs at most a 1 GB temporary
DRAW_CHUNK = 1 << 28


def normal(shape, gen: Optional[torch.Generator], device, std: float,
           dtype=torch.float32) -> torch.Tensor:
    """``std`` times standard normal draws of ``gen`` in float32, cast to
    ``dtype``; on the ``meta`` device only the shape."""
    device = torch.device(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - i)
        flat[i:i + n] = torch.randn(n, generator=gen, device=device,
                                    dtype=torch.float32).mul_(std)
    # grit-lint: disable=donation-aliasing -- out is filled through its flat view on purpose; this returns the filled tensor
    return out


def dense_init(gen, shape, device, dtype=torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """A ``[..., d_in, d_out]`` weight with std ``1 / sqrt(d_in)``."""
    d_in = shape[-2]
    scale = scale if scale is not None else (1.0 / math.sqrt(d_in))
    return normal(shape, gen, device, scale, dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def norm_params(cfg: LMConfig, device, lead=()) -> dict:
    d = (*lead, cfg.d_model)
    if cfg.norm == "rms":
        return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def apply_norm(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"], cfg.norm_eps)
    return layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(cfg: LMConfig, device=None) -> torch.Tensor:
    rot = int(cfg.head_dim * cfg.rope_fraction) // 2 * 2
    base = torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device)
    return 1.0 / (base ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] (or [S]); rotate the first
    2*|freqs| dims as interleaved pairs (x[..., ::2], x[..., 1::2])."""
    rot = 2 * freqs.shape[0]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs    # [B, S, rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# attention cores (all take q [B, H, Sq, D], k/v [B, H, Sk, D])
# --------------------------------------------------------------------------

def _logits(q, k, scale, logit_dtype):
    """q k^T accumulated in float32, stored in ``logit_dtype``, scaled
    in float32."""
    lg = q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)
    return lg.to(logit_dtype).to(torch.float32) * scale


def _mask_logits(logits, qpos, kpos, causal, window, sk_valid=None):
    mask = torch.ones(logits.shape[-2:], dtype=torch.bool,
                      device=logits.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    if sk_valid is not None:
        mask = mask & sk_valid
    return torch.where(mask, logits, NEG_INF)


def _soft_cap(logits, cap):
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def attn_direct(q, k, v, *, causal, window, softcap, scale, q_offset=0,
                logit_dtype=torch.float32):
    logits = _soft_cap(_logits(q, k, scale, logit_dtype), softcap)
    Sq, Sk = q.shape[2], k.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    logits = _mask_logits(logits, qpos, kpos, causal, window)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return p @ v


def attn_rect(q, k, v, *, causal, window, softcap, scale, chunk, q_offset=0,
              logit_dtype=torch.float32):
    """Online-softmax loop over KV chunks (flash semantics, plain torch)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j in range(Sk // chunk):
        kj = k[:, :, j * chunk:(j + 1) * chunk]
        vj = v[:, :, j * chunk:(j + 1) * chunk]
        logits = _soft_cap(_logits(q, kj, scale, logit_dtype), softcap)
        kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        logits = _mask_logits(logits, qpos, kpos, causal, window)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + (p.to(vj.dtype) @ vj).to(torch.float32)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def attn_tri(q, k, v, *, causal, softcap, scale, chunk, q_offset=0,
             logit_dtype=torch.float32):
    """Causal attention over the static lower-triangular block schedule.

    Exact triangular FLOPs: visits the (qi, kj) block pairs with
    kj <= qi + shift in the reference's order (assumes q/k aligned:
    q_offset == Sk - Sq and both chunked the same)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    nq, nk = Sq // chunk, Sk // chunk
    shift = (Sk - Sq) // chunk        # q block i aligns to k block i+shift
    m = [torch.full((B, H, chunk, 1), NEG_INF, dtype=torch.float32,
                    device=q.device) for _ in range(nq)]
    l = [torch.zeros((B, H, chunk, 1), dtype=torch.float32, device=q.device)
         for _ in range(nq)]
    acc = [torch.zeros((B, H, chunk, D), dtype=torch.float32, device=q.device)
           for _ in range(nq)]
    ar = torch.arange(chunk, device=q.device)
    for i in range(nq):
        qi = q[:, :, i * chunk:(i + 1) * chunk]
        for j in range(nk):
            if j > i + shift:
                continue
            kj = k[:, :, j * chunk:(j + 1) * chunk]
            vj = v[:, :, j * chunk:(j + 1) * chunk]
            logits = _soft_cap(_logits(qi, kj, scale, logit_dtype), softcap)
            qpos = i * chunk + ar[:, None] + q_offset
            kpos = j * chunk + ar[None, :]
            logits = torch.where(kpos <= qpos, logits, NEG_INF)
            m_new = torch.maximum(m[i], logits.amax(dim=-1, keepdim=True))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m[i] - m_new)
            l[i] = l[i] * alpha + p.sum(dim=-1, keepdim=True)
            acc[i] = acc[i] * alpha + p.to(vj.dtype) @ vj
            m[i] = m_new
    out = torch.cat([a / torch.clamp_min(li, 1e-30) for a, li in zip(acc, l)],
                    dim=2)
    return out.to(q.dtype)


def attn_banded(q, k, v, *, window, softcap, scale, chunk, q_offset=0,
                logit_dtype=torch.float32):
    """Sliding-window attention over the static band schedule.

    For each q block, takes the fixed-width KV band [start, start + W')
    with W' = window rounded up to a chunk multiple plus one chunk; masks
    exactly. FLOPs O(Sq * (window + chunk))."""
    Sq = q.shape[2]
    Sk = k.shape[2]
    nq = Sq // chunk
    band = min(((window + chunk - 1) // chunk + 1) * chunk, Sk)
    outs = []
    for i in range(nq):
        qi = q[:, :, i * chunk:(i + 1) * chunk]
        q_lo = i * chunk + q_offset
        start = min(max(q_lo + chunk - 1 - (band - 1), 0), Sk - band)
        kj = k[:, :, start:start + band]
        vj = v[:, :, start:start + band]
        logits = _soft_cap(_logits(qi, kj, scale, logit_dtype), softcap)
        qpos = q_lo + torch.arange(chunk, device=q.device)[:, None]
        kpos = start + torch.arange(band, device=q.device)[None, :]
        logits = _mask_logits(logits, qpos, kpos, True, window)
        p = torch.softmax(logits, dim=-1).to(vj.dtype)
        outs.append(p @ vj)
    return torch.cat(outs, dim=2)


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, impl="auto", chunk=1024, q_offset=None,
              logit_dtype=torch.float32, use_flash=False):
    """Dispatch across attention paths. q/k/v: [B, H, S, D].

    ``use_flash`` takes ``kernels.ops.flash_attention`` whatever ``impl``
    says (right-aligned queries only; it keeps its logits in float32); it
    also takes k / v with fewer heads than q (GQA, read in place)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    if use_flash:
        if q_offset != Sk - Sq:
            raise ValueError("flash attention aligns query i to key "
                             f"i + Sk - Sq; got q_offset {q_offset}")
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, softcap=softcap,
                                   scale=scale)
    if impl == "auto":
        if Sq == 1 or Sk <= 2 * chunk:
            impl = "direct"
        elif window is not None and window < Sk:
            impl = "banded"
        else:
            impl = "rect"
    ld = dtype_of(logit_dtype)
    if impl == "direct" or Sk < chunk or Sk % chunk:
        return attn_direct(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, q_offset=q_offset,
                           logit_dtype=ld)
    if impl == "banded" and window is not None:
        return attn_banded(q, k, v, window=window, softcap=softcap,
                           scale=scale, chunk=chunk, q_offset=q_offset,
                           logit_dtype=ld)
    if impl == "tri" and causal and Sq % chunk == 0:
        return attn_tri(q, k, v, causal=causal, softcap=softcap,
                        scale=scale, chunk=chunk, q_offset=q_offset,
                        logit_dtype=ld)
    return attn_rect(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale, chunk=chunk, q_offset=q_offset,
                     logit_dtype=ld)


# --------------------------------------------------------------------------
# GQA attention layer (params + forward incl. KV cache)
# --------------------------------------------------------------------------

def attn_params(cfg: LMConfig, gen, device, lead=()) -> dict:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = dtype_of(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, (*lead, d, H * Dh), device, pd),
        "wk": dense_init(gen, (*lead, d, KV * Dh), device, pd),
        "wv": dense_init(gen, (*lead, d, KV * Dh), device, pd),
        "wo": dense_init(gen, (*lead, H * Dh, d), device, pd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, H * Dh), dtype=pd, device=device)
        p["bk"] = torch.zeros((*lead, KV * Dh), dtype=pd, device=device)
        p["bv"] = torch.zeros((*lead, KV * Dh), dtype=pd, device=device)
    return p


def _project_qkv(cfg: LMConfig, p: dict, x: torch.Tensor):
    """q [B, S, H, Dh], k / v [B, S, KV, Dh], with as many heads as the
    weights hold columns for (a tensor-parallel rank's own)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(B, S, -1, Dh), k.reshape(B, S, -1, Dh),
            v.reshape(B, S, -1, Dh))


def _broadcast_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """[B, KV, S, D] -> [B, KV*q_per_kv, S, D] (head h reads KV head
    h // q_per_kv)."""
    if q_per_kv == 1:
        return k
    B, KV, S, D = k.shape
    return k[:, :, None].expand(B, KV, q_per_kv, S, D).reshape(
        B, KV * q_per_kv, S, D)


def attn_forward(cfg: LMConfig, p: dict, x: torch.Tensor, freqs: torch.Tensor,
                 *, window: Optional[int], cache: Optional[dict] = None,
                 positions: Optional[torch.Tensor] = None) -> tuple:
    """Self-attention with optional KV cache.

    cache (decode): {"k": [B, KV, S_cache, Dh], "v": same, "pos": int}.
    If ``window`` is set the cache is a ring buffer of size min(S_cache,
    window).  Returns (out [B, S, d], new_cache).  The cache tensors are
    written in place (the reference builds new arrays; the port saves the
    copy), so ``new_cache`` holds the same tensors as ``cache``.

    Under tensor parallelism (``tensor_parallel.active``) a rank whose
    model axis divides the heads computes its own q heads and the KV
    heads they read, ``wo`` row-parallel (``tensor_parallel.attn_heads``);
    its cache holds those KV heads, or every KV head, which it then
    projects and writes all of and reads its own.  Otherwise attention is
    whole.  A cache with a ``"seq"`` entry (``tensor_parallel.SeqShard``)
    is the rank's shard of the sequence: the rank writes the positions it
    owns, and a decode step's attention is split over the shards
    (:func:`_masked_decode_attn`).
    """
    B, S, _ = x.shape
    ax = tp.active(cfg)
    heads = tp.attn_heads(cfg, ax)
    seq = None if cache is None else cache.get("seq")
    # a cache of every KV head under split q heads: project them all
    all_kv = heads is not None and cache is not None and \
        cache["k"].shape[1] == cfg.num_kv_heads != heads.kv1 - heads.kv0
    p = tp.attn_weights(cfg, p, ax, heads, all_kv)
    if heads is not None:
        x = tp.copy_in(x, ax.group)
    q_per_kv = cfg.q_per_kv if heads is None else heads.q_per_kv
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        start = 0 if cache is None else cache["pos"]
        positions = torch.arange(start, start + S, device=x.device)[None, :]
    q = apply_rope(q, positions, freqs)
    k = apply_rope(k, positions, freqs)
    q = q.transpose(1, 2)               # [B, H, S, Dh]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    new_cache = None
    if cache is not None:
        # Cache layout: when ``window`` is set the cache was allocated as a
        # ring buffer with S_c <= window entries (init_cache), so every
        # live entry is inside the window by construction and only a
        # validity mask is needed.  RoPE is applied pre-cache with absolute
        # positions, so ring rotation does not disturb relative phases.
        ck, cv = cache["k"], cache["v"]
        n = ck.shape[2]                 # the positions this rank holds
        lo, _ = (0, n) if seq is None else seq.span(n)
        S_c = n if seq is None else n * seq.size
        pos = cache["pos"]
        ring = window is not None
        if S == 1:
            slot = (pos % S_c) if ring else pos
            slot = min(max(slot, 0), S_c - 1) - lo  # the reference's clamp
            if 0 <= slot < n:
                ck[:, :, slot] = k[:, :, 0]
                cv[:, :, slot] = v[:, :, 0]
        else:
            # prefill into an empty cache, or its trailing window: cache
            # position j holds prompt position j + first
            first = max(S - S_c, 0)
            hi = min(lo + n, S - first)
            if hi > lo:
                ck[:, :, :hi - lo] = k[:, :, first + lo:first + hi]
                cv[:, :, :hi - lo] = v[:, :, first + lo:first + hi]
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + S}
        # of every KV head, the ones this rank's q heads read
        kv = slice(heads.kv0, heads.kv1) if all_kv else slice(None)
        if S == 1:
            # decode: attend over the valid cached prefix
            idx = lo + torch.arange(n, device=x.device)
            valid = (idx <= pos) | (pos >= S_c)
            qpk = q_per_kv
            if seq is None:
                ck, cv = ck[:, kv], cv[:, kv]
            elif heads is not None:
                # every q head against this rank's keys
                q, qpk = tp.gather_heads(q, ax), cfg.q_per_kv
            out = _masked_decode_attn(cfg, q, _broadcast_kv(ck, qpk),
                                      _broadcast_kv(cv, qpk), valid,
                                      softcap=cfg.attn_softcap, seq=seq)
            if seq is not None and heads is not None:
                out = out[:, heads.h0:heads.h1]
        else:
            out = _prefill_attn(cfg, q, k[:, kv], v[:, kv], window,
                                q_per_kv)
    else:
        out = _prefill_attn(cfg, q, k, v, window, q_per_kv)

    out = out.transpose(1, 2).reshape(B, S, -1)
    out = out @ p["wo"].to(out.dtype)
    if heads is not None:
        out = tp.reduce_out(out, [ax.group])
    return out, new_cache


def _prefill_attn(cfg: LMConfig, q, k, v, window, q_per_kv=None):
    """Causal self-attention of a prompt: the flash kernel reads the
    un-broadcast k / v through its GQA map (q head h reads KV head
    ``h // q_per_kv``, by default the config's); the other paths take
    them broadcast to every query head."""
    if q_per_kv is None:
        q_per_kv = cfg.q_per_kv
    if not cfg.use_flash_kernel:
        k = _broadcast_kv(k, q_per_kv)
        v = _broadcast_kv(v, q_per_kv)
    return attention(q, k, v, causal=True, window=window,
                     softcap=cfg.attn_softcap, impl=cfg.attn_impl,
                     chunk=cfg.attn_chunk, logit_dtype=cfg.logit_dtype,
                     use_flash=cfg.use_flash_kernel)


def _masked_decode_attn(cfg, q, k, v, valid, softcap=None, seq=None):
    """Attention of q [B, H, Sq, Dh] over the keys k / v [B, H, Sk, Dh]
    where ``valid`` [Sk].  With ``seq`` (a ``tensor_parallel.SeqShard``)
    the keys are this rank's shard of the sequence and the softmax is
    split over the shards in the reference's order, as XLA partitions it:
    float32 logits over the local keys, their row max and its sum of
    ``exp`` each combined over the shards (``all_reduce`` MAX, SUM), the
    reference's ``p`` in ``v``'s dtype, and its local ``p v`` in float32
    summed over the shards."""
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) \
        * cfg.head_dim ** -0.5
    logits = _soft_cap(logits, softcap)
    logits = torch.where(valid, logits, NEG_INF)
    if seq is None:
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        return p @ v
    m = seq.all_reduce(logits.amax(dim=-1), "max")[..., None]
    e = torch.exp(logits - m)
    l = seq.all_reduce(e.sum(dim=-1), "sum")[..., None]
    p = (e / l).to(v.dtype)
    out = p.to(torch.float32) @ v.to(torch.float32)
    return seq.all_reduce(out, "sum").to(v.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_params(cfg: LMConfig, gen, device, lead=(),
               d_ff: Optional[int] = None) -> dict:
    ff = d_ff or cfg.d_ff
    d = cfg.d_model
    pd = dtype_of(cfg.param_dtype)
    if cfg.mlp_kind == "glu":
        return {"w_gate": dense_init(gen, (*lead, d, ff), device, pd),
                "w_up": dense_init(gen, (*lead, d, ff), device, pd),
                "w_down": dense_init(gen, (*lead, ff, d), device, pd)}
    return {"w_up": dense_init(gen, (*lead, d, ff), device, pd),
            "w_down": dense_init(gen, (*lead, ff, d), device, pd)}


def _act(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def mlp_forward(cfg: LMConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The MLP; under tensor parallelism column-parallel ``w_gate`` /
    ``w_up`` and row-parallel ``w_down`` over ``d_ff`` where the model
    axis divides it (``tensor_parallel.mlp_split``)."""
    ax = tp.active(cfg)
    p, split = tp.mlp_split(cfg, p, ax)
    if split:
        x = tp.copy_in(x, ax.group)
    if cfg.mlp_kind == "glu":
        h = _act(cfg, x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = _act(cfg, x @ p["w_up"].to(x.dtype))
    y = h @ p["w_down"].to(x.dtype)
    return tp.reduce_out(y, [ax.group]) if split else y
