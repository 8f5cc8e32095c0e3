"""Block assembly and layer stacks for every architecture family.

Layers are organized into *groups*: ``group_layout(cfg)`` returns the
static tuple of block kinds that make up one group, and the full network
is ``num_groups(cfg)`` repetitions, run as a Python loop over the
leading group axis of the stacked parameters (the reference scans it
with ``lax.scan``).  Under grad with ``cfg.remat`` each group runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so the
backward pass keeps only each group's input and recomputes the rest;
serving (no tensor that requires grad) is untouched.  Examples:

  qwen2     -> ("attn:full",) x 28 groups
  mixtral   -> ("moe:swa",) x 32
  gemma2    -> ("attn:swa", "attn:full") x 23   (local/global alternation)
  zamba2    -> ("shared_attn", "mamba" x 6) x 9 (shared-params attn block)
  rwkv6     -> ("rwkv",) x 32
  whisper   -> encoder ("enc_attn",) x 12 + decoder ("dec_attn",) x 12
  internvl2 -> ("attn:full",) x 24            (the dense layout)

Block kinds carry their attention window statically.  An unknown family
or block kind raises ``ValueError``, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import moe as M
from . import rwkv as R
from . import ssm as SSM
from . import tensor_parallel as TP
from .config import LMConfig
from .sharding_ctx import constrain

# --------------------------------------------------------------------------
# group layout
# --------------------------------------------------------------------------

def group_layout(cfg: LMConfig) -> Tuple[str, ...]:
    if cfg.family in ("dense", "vlm"):
        if cfg.attn_kind == "local_global":
            return ("attn:swa", "attn:full")
        if cfg.attn_kind == "swa":
            return ("attn:swa",)
        return ("attn:full",)
    if cfg.family == "moe":
        return ("moe:swa",) if cfg.attn_kind == "swa" else ("moe:full",)
    if cfg.family == "rwkv":
        return ("rwkv",)
    if cfg.family == "hybrid":
        return ("shared_attn",) + ("mamba",) * cfg.shared_attn_every
    if cfg.family == "encdec":
        return ("dec_attn",)
    raise ValueError(f"unknown family {cfg.family!r}")


def num_groups(cfg: LMConfig) -> int:
    if cfg.family == "hybrid":
        assert cfg.num_layers % cfg.shared_attn_every == 0
        return cfg.num_layers // cfg.shared_attn_every
    per = len(group_layout(cfg))
    assert cfg.num_layers % per == 0
    return cfg.num_layers // per


def _kind_window(cfg: LMConfig, kind: str) -> Optional[int]:
    return cfg.window if kind.endswith(":swa") else None


# --------------------------------------------------------------------------
# per-kind params / cache / forward
# --------------------------------------------------------------------------

def block_params(cfg: LMConfig, kind: str, gen, device, lead=()) -> dict:
    """One block's params; ``lead`` prepends stacked axes to every leaf."""
    if kind.startswith("attn:") or kind == "enc_attn":
        return {"ln1": L.norm_params(cfg, device, lead),
                "attn": L.attn_params(cfg, gen, device, lead),
                "ln2": L.norm_params(cfg, device, lead),
                "mlp": L.mlp_params(cfg, gen, device, lead)}
    if kind.startswith("moe:"):
        p = {"ln1": L.norm_params(cfg, device, lead),
             "attn": L.attn_params(cfg, gen, device, lead),
             "ln2": L.norm_params(cfg, device, lead),
             "moe": M.moe_params(cfg, gen, device, lead)}
        if cfg.moe.dense_residual:
            p["mlp"] = L.mlp_params(cfg, gen, device, lead)
        return p
    if kind == "rwkv":
        return {"ln1": L.norm_params(cfg, device, lead),
                "tm": R.rwkv_time_mix_params(cfg, gen, device, lead),
                "ln2": L.norm_params(cfg, device, lead),
                "cm": R.rwkv_channel_mix_params(cfg, gen, device, lead)}
    if kind == "mamba":
        return {"ln": L.norm_params(cfg, device, lead),
                "mamba": SSM.mamba_params(cfg, gen, device, lead)}
    if kind == "shared_attn":
        return {}                  # the params live at params["shared"]
    if kind == "dec_attn":
        return {"ln1": L.norm_params(cfg, device, lead),
                "attn": L.attn_params(cfg, gen, device, lead),
                "ln_x": L.norm_params(cfg, device, lead),
                "xattn": L.attn_params(cfg, gen, device, lead),
                "ln2": L.norm_params(cfg, device, lead),
                "mlp": L.mlp_params(cfg, gen, device, lead)}
    raise ValueError(f"unknown block kind {kind!r}")


def init_block_cache(cfg: LMConfig, kind: str, batch: int, max_len: int,
                     dtype, device, lead=()) -> dict:
    """A zeroed cache; the encoder's ``enc_attn`` blocks have none."""
    d = cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)

    if kind == "rwkv":
        # a tensor-parallel rank's state holds the heads its time mix runs
        Dh_r = d // cfg.num_heads
        return {"wkv": zeros(TP.cache_rwkv_heads(cfg), Dh_r, Dh_r,
                             dt=torch.float32),
                "shift_tm": zeros(d), "shift_cm": zeros(d)}
    if kind == "mamba":
        nh = cfg.n_ssm_heads
        return {"ssm": zeros(nh, cfg.ssm_state, cfg.d_inner // nh,
                             dt=torch.float32),
                "conv": zeros(cfg.conv_width - 1,
                              cfg.d_inner + 2 * cfg.ssm_state)}
    if not (kind.startswith("attn:") or kind.startswith("moe:")
            or kind in ("shared_attn", "dec_attn")):
        raise ValueError(f"no cache for block kind {kind!r}")
    # attn:* / moe:* (ring buffer of the window); shared_attn and dec_attn
    # full, dec_attn also the cross-attention K / V of the encoder output
    window = _kind_window(cfg, kind)
    S_c = max_len if window is None else min(max_len, window)
    # a tensor-parallel rank holds the KV heads its q heads read
    KV, Dh = TP.cache_kv_heads(cfg), cfg.head_dim
    c = {"k": zeros(KV, S_c, Dh), "v": zeros(KV, S_c, Dh)}
    if kind == "dec_attn":
        c["xk"] = zeros(KV, cfg.enc_seq, Dh)
        c["xv"] = zeros(KV, cfg.enc_seq, Dh)
    return c


def _copy_into(cache: dict, new: dict) -> None:
    """Write a recurrent block's new state into its cache views."""
    for name, t in new.items():
        cache[name].copy_(t)


def block_forward(cfg: LMConfig, kind: str, p: dict, x: torch.Tensor,
                  freqs: torch.Tensor, cache: Optional[dict],
                  shared: Optional[dict] = None,
                  enc_out: Optional[torch.Tensor] = None):
    """One block; ``cache``, when given, is written in place (attention:
    {"k", "v", "pos"}; dec_attn also reads {"xk", "xv"}; rwkv: {"wkv",
    "shift_tm", "shift_cm"}; mamba: {"ssm", "conv"}).  Without a cache a
    dec_attn block attends to ``enc_out``.  Returns (x, aux): the MoE
    block's load-balancing loss (f32 scalar), None for every other kind."""
    if kind == "shared_attn":
        # falls through to the attention path with full-window KV
        p, kind = shared, "attn:full"
    if kind.startswith("attn:") or kind.startswith("moe:") \
            or kind == "enc_attn":
        h = L.apply_norm(cfg, p["ln1"], x)
        if kind == "enc_attn":
            a = _noncausal_self_attn(cfg, p["attn"], h)
        else:
            a, _ = L.attn_forward(cfg, p["attn"], h, freqs,
                                  window=_kind_window(cfg, kind), cache=cache)
        x = constrain(x + a, "res")
        h = L.apply_norm(cfg, p["ln2"], x)
        aux = None
        if kind.startswith("moe:"):
            y, aux = M.moe_forward(cfg, p["moe"], h)
            if cfg.moe.dense_residual:
                y = y + L.mlp_forward(cfg, p["mlp"], h)
        else:
            y = L.mlp_forward(cfg, p["mlp"], h)
        return constrain(x + y, "res"), aux
    if kind == "rwkv":
        st_tm = None if cache is None else \
            {"wkv": cache["wkv"], "shift": cache["shift_tm"]}
        h = L.apply_norm(cfg, p["ln1"], x)
        a, new_tm = R.rwkv_time_mix(cfg, p["tm"], h, st_tm)
        x = constrain(x + a, "res")
        st_cm = None if cache is None else {"shift": cache["shift_cm"]}
        h = L.apply_norm(cfg, p["ln2"], x)
        y, new_cm = R.rwkv_channel_mix(cfg, p["cm"], h, st_cm)
        if cache is not None:
            _copy_into(cache, {"wkv": new_tm["wkv"],
                               "shift_tm": new_tm["shift"],
                               "shift_cm": new_cm["shift"]})
        return constrain(x + y, "res"), None
    if kind == "mamba":
        st = None if cache is None else {"ssm": cache["ssm"],
                                         "conv": cache["conv"]}
        h = L.apply_norm(cfg, p["ln"], x)
        y, new_st = SSM.mamba_forward(cfg, p["mamba"], h, st)
        if cache is not None:
            _copy_into(cache, new_st)
        return constrain(x + y, "res"), None
    if kind == "dec_attn":
        h = L.apply_norm(cfg, p["ln1"], x)
        a, _ = L.attn_forward(cfg, p["attn"], h, freqs, window=None,
                              cache=cache)
        x = constrain(x + a, "res")
        h = L.apply_norm(cfg, p["ln_x"], x)
        if cache is not None:
            xa = _cross_attn_cached(cfg, p["xattn"], h, cache["xk"],
                                    cache["xv"], cache.get("xseq"))
        else:
            xa = _cross_attn(cfg, p["xattn"], h, enc_out)
        x = constrain(x + xa, "res")
        h = L.apply_norm(cfg, p["ln2"], x)
        return constrain(x + L.mlp_forward(cfg, p["mlp"], h), "res"), None
    raise ValueError(f"unknown block kind {kind!r}")


def _unmasked_attn(cfg: LMConfig, q, k, v, q_per_kv: int):
    """Attention with no mask (the encoder's self-attention, the decoder's
    cross-attention; neither soft-caps, as in the reference).  q [B, H,
    Sq, Dh], k / v [B, KV, Sk, Dh], q head h reading KV head ``h //
    q_per_kv``: the flash kernel reads them un-broadcast through its GQA
    map, the plain paths take them broadcast to every query head.  One
    query row (a decode step's cross-attention) stays plain, as decode
    does (``layers.py``)."""
    flash = cfg.use_flash_kernel and q.shape[2] > 1
    if not flash:
        k = L._broadcast_kv(k, q_per_kv)
        v = L._broadcast_kv(v, q_per_kv)
    return L.attention(q, k, v, causal=False, impl=cfg.attn_impl,
                       chunk=cfg.attn_chunk, logit_dtype=cfg.logit_dtype,
                       use_flash=flash)


def _split(cfg: LMConfig, p: dict, x: torch.Tensor, *more):
    """Tensor parallelism for an unmasked attention: (the weights a rank
    computes with, ``x`` and ``more`` entered through ``copy_in`` where
    its heads split, the model axis, the heads, the q heads a KV head
    serves) (``tensor_parallel.attn_heads``)."""
    ax = TP.active(cfg)
    heads = TP.attn_heads(cfg, ax)
    p = TP.attn_weights(cfg, p, ax, heads)
    if heads is not None:
        x, *more = (TP.copy_in(t, ax.group) for t in (x, *more))
    qpk = cfg.q_per_kv if heads is None else heads.q_per_kv
    return p, x, more, ax, heads, qpk


def _attn_out(p: dict, out, ax, heads):
    """``out`` [B, H, S, Dh] through ``wo``, row-parallel where the
    heads split."""
    B, _, S, _ = out.shape
    out = out.transpose(1, 2).reshape(B, S, -1)
    out = out @ p["wo"].to(out.dtype)
    return out if heads is None else TP.reduce_out(out, [ax.group])


def _noncausal_self_attn(cfg: LMConfig, p: dict, x: torch.Tensor):
    """The encoder's self-attention, on the rank's heads under tensor
    parallelism.  It rotates q / k by RoPE at positions ``arange(S)``, as
    the reference does (Whisper itself adds learned positions to the
    frames)."""
    B, S, _ = x.shape
    p, x, _, ax, heads, qpk = _split(cfg, p, x)
    q, k, v = L._project_qkv(cfg, p, x)
    pos = torch.arange(S, device=x.device)[None, :]
    freqs = L.rope_freqs(cfg, x.device)
    q = L.apply_rope(q, pos, freqs).transpose(1, 2)
    k = L.apply_rope(k, pos, freqs).transpose(1, 2)
    out = _unmasked_attn(cfg, q, k, v.transpose(1, 2), qpk)
    return _attn_out(p, out, ax, heads)


def _cross_attn(cfg: LMConfig, p: dict, x: torch.Tensor,
                enc_out: torch.Tensor):
    """Cross-attention to ``enc_out`` [B, T, d], K / V projected here (on
    the rank's heads under tensor parallelism)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    p, x, (enc_out,), ax, heads, qpk = _split(cfg, p, x, enc_out)
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, -1, Dh)
    k = (enc_out @ p["wk"].to(x.dtype)).reshape(B, -1, q.shape[2] // qpk, Dh)
    v = (enc_out @ p["wv"].to(x.dtype)).reshape(B, -1, q.shape[2] // qpk, Dh)
    out = _unmasked_attn(cfg, q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), qpk)
    return _attn_out(p, out, ax, heads)


def _cross_attn_cached(cfg: LMConfig, p: dict, x: torch.Tensor,
                       xk: torch.Tensor, xv: torch.Tensor, xseq=None):
    """Cross-attention to the cached K / V [B, KV, T, Dh]: the rank's KV
    heads under tensor parallelism, or every KV head, of which the rank
    reads those its q heads read; with ``xseq`` (a
    ``tensor_parallel.SeqShard``) the rank's shard of the T frames, the
    softmax split over the shards (``layers._masked_decode_attn``)."""
    B, S, _ = x.shape
    p, x, _, ax, heads, qpk = _split(
        cfg, {k: p[k] for k in ("wq", "wo")}, x)
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, -1, cfg.head_dim)
    q = q.transpose(1, 2)
    if xseq is not None:
        if heads is not None:
            q = TP.gather_heads(q, ax)
        valid = torch.ones(xk.shape[2], dtype=torch.bool, device=x.device)
        out = L._masked_decode_attn(
            cfg, q, L._broadcast_kv(xk, cfg.q_per_kv),
            L._broadcast_kv(xv, cfg.q_per_kv), valid, seq=xseq)
        if heads is not None:
            out = out[:, heads.h0:heads.h1]
    else:
        if heads is not None and xk.shape[1] != heads.kv1 - heads.kv0:
            xk = xk[:, heads.kv0:heads.kv1]
            xv = xv[:, heads.kv0:heads.kv1]
        out = _unmasked_attn(cfg, q, xk, xv, qpk)
    return _attn_out(p, out, ax, heads)


# --------------------------------------------------------------------------
# stacked groups
# --------------------------------------------------------------------------

def stack_params(cfg: LMConfig, gen, device, layout: Tuple[str, ...],
                 groups: int):
    """Params for `groups` repetitions of `layout`, leaves stacked on axis 0."""
    return tuple(block_params(cfg, kind, gen, device, lead=(groups,))
                 for kind in layout)


def _index(tree, g: int):
    """Group ``g`` of every tensor of a stacked tree (a cache's shard
    descriptors pass as they are)."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g] if isinstance(tree, torch.Tensor) else tree


def leaves(tree):
    """The tensors of a nested dict / tuple tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def stack_forward(cfg: LMConfig, stacked, x: torch.Tensor,
                  layout: Tuple[str, ...], *, cache=None,
                  shared: Optional[dict] = None,
                  enc_out: Optional[torch.Tensor] = None):
    """Run `x` through all groups. cache: {"pos": int, "slots": tuple of
    per-slot caches with a leading group axis} (or None), written in
    place.  ``shared``: the hybrid family's shared attention block;
    ``enc_out``: the encoder output an uncached dec_attn block attends to.
    Returns (x, new_cache, aux): ``aux`` sums the MoE blocks' aux losses
    in group order (an f32 zero without MoE blocks)."""
    freqs = L.rope_freqs(cfg, x.device)
    pos = None if cache is None else cache["pos"]
    # the group count of the tree itself (a shared_attn slot has no leaf)
    G = next(leaves(stacked)).shape[0]

    def group(x, aux, g):
        for i, kind in enumerate(layout):
            slot_cache = None
            if cache is not None:
                slot_cache = _index(cache["slots"][i], g)
                slot_cache["pos"] = pos
            x, a = block_forward(cfg, kind, _index(stacked[i], g), x, freqs,
                                 slot_cache, shared=shared, enc_out=enc_out)
            if a is not None:       # 0 + a == a: the reference's sum
                aux = a if aux is None else aux + a
        return x, aux

    # only where a gradient is being recorded: serving (no grad, or no
    # tensor that requires one) runs the groups as they are
    remat = cfg.remat and cache is None and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in leaves(stacked)))
    aux = None
    for g in range(G):
        if remat:
            x, aux = checkpoint(group, x, aux, g, use_reentrant=False)
        else:
            x, aux = group(x, aux, g)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = None
    if cache is not None:
        new_cache = {"pos": pos + x.shape[1], "slots": cache["slots"]}
    return x, new_cache, aux
