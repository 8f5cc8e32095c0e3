"""RWKV6 "Finch" blocks (rwkv6-3b): attention-free, data-dependent decay.

The per-timestep recurrence

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    y_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

is evaluated *chunkwise* as in the reference (``repro.models.rwkv``):
within a chunk of length C the intra-chunk term becomes masked matmuls
against cumulative log-decays, and a Python loop over the chunks (the
reference's ``lax.scan``) carries the [H, Dk, Dv] state across them.

Numerics: decays are computed in log space; per-step log-decay is clamped
at ``LOG_DECAY_MIN`` so intra-chunk exp() factors stay inside f32 range
(the reference's documented deviation).  ``wkv_sequential`` is the exact
oracle used by the tests and the card check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from . import tensor_parallel as tp
from .config import LMConfig

LOG_DECAY_MIN = -5.0
LORA_DIM = 64


def rwkv_time_mix_params(cfg: LMConfig, gen, device, lead=()) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    Dh = d // H
    pd = L.dtype_of(cfg.param_dtype)

    def full(shape, value):
        return torch.full((*lead, *shape), value, dtype=pd, device=device)

    return {
        # token-shift interpolation coefficients for r,k,v,g,w
        "mu": full((5, d), 0.5),
        "w_r": L.dense_init(gen, (*lead, d, d), device, pd),
        "w_k": L.dense_init(gen, (*lead, d, d), device, pd),
        "w_v": L.dense_init(gen, (*lead, d, d), device, pd),
        "w_g": L.dense_init(gen, (*lead, d, d), device, pd),
        "w_o": L.dense_init(gen, (*lead, d, d), device, pd),
        # data-dependent decay: w0 + tanh(x A) B   (low-rank lora)
        "w0": full((d,), -0.6),
        "dec_a": L.dense_init(gen, (*lead, d, LORA_DIM), device, pd,
                              scale=0.01),
        "dec_b": L.dense_init(gen, (*lead, LORA_DIM, d), device, pd,
                              scale=0.01),
        "u": L.normal((*lead, H, Dh), gen, device, 0.1, pd),
        "ln_scale": full((d,), 1.0),   # per-head group norm on wkv out
    }


def rwkv_channel_mix_params(cfg: LMConfig, gen, device, lead=()) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    pd = L.dtype_of(cfg.param_dtype)
    return {
        "mu": torch.full((*lead, 2, d), 0.5, dtype=pd, device=device),
        "w_k": L.dense_init(gen, (*lead, d, ff), device, pd),
        "w_v": L.dense_init(gen, (*lead, ff, d), device, pd),
        "w_r": L.dense_init(gen, (*lead, d, d), device, pd),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Previous-token features; ``last`` [B, d] seeds position 0 (decode)."""
    if last is None:
        last = torch.zeros_like(x[:, 0])
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _decays(p: dict, xw: torch.Tensor, cols=None) -> torch.Tensor:
    """log-decay per channel, clamped. xw: [B, S, d] -> [B, S, d] (f32, <0).

    ``cols`` ``(lo, hi, model axis)``: the channels ``[lo, hi)`` only,
    from the whole low-rank input (entered through ``copy_in``) and the
    rank's columns of ``dec_b`` and ``w0``."""
    f32 = torch.float32
    a = torch.tanh(xw.to(f32) @ p["dec_a"].to(f32))
    w0, dec_b = p["w0"], p["dec_b"]
    if cols is not None:
        lo, hi, ax = cols
        a = tp.copy_in(a, ax.group)
        d = w0.shape[-1]
        w0, dec_b = (tp.take(w, -1, d, lo, hi, ax) for w in (w0, dec_b))
    lora = a @ dec_b.to(f32)
    lw = -torch.exp(torch.clamp(w0.to(f32) + lora, -8.0, 4.0))
    return torch.clamp(lw, LOG_DECAY_MIN, -1e-4)


def _wkv_chunk(r, k, v, lw, u, state):
    """One chunk of the WKV recurrence.

    r/k/v: [B, C, H, Dh(k|v)] f32; lw: [B, C, H, Dk] f32 log decays;
    u: [H, Dk]; state: [B, H, Dk, Dv].
    Returns (y [B, C, H, Dv], new state)."""
    C = k.shape[1]
    Lc = torch.cumsum(lw, dim=1)               # inclusive
    Lm1 = Lc - lw                              # exclusive
    r_t = r * torch.exp(Lm1)                   # <= |r|
    k_s = k * torch.exp(-Lc)                   # bounded by clamp
    scores = torch.einsum("bthi,bshi->bhts", r_t, k_s)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)             # strictly s < t
    scores = torch.where(mask[None, None], scores, 0.0)
    y = torch.einsum("bhts,bshj->bthj", scores, v)
    # current-token bonus
    bonus = torch.einsum("bthi,bthi,hi->bth", r, k, u)
    y = y + bonus[..., None] * v
    # state contribution
    y = y + torch.einsum("bthi,bhij->bthj", r_t, state)
    # state update
    decay_all = torch.exp(Lc[:, -1])           # [B, H, Dk]
    k_rem = k_s * decay_all[:, None]           # k * exp(L_C - L_s)
    new_state = state * decay_all[..., None] + \
        torch.einsum("bshi,bshj->bhij", k_rem, v)
    return y, new_state


def _wkv_scan(r, k, v, lw, u, s0, chunk: int):
    """``_wkv_chunk`` over the sequence in chunks of ``chunk``, the state
    carried across (one chunk over all of it when ``chunk`` does not
    divide S, or S == 1).  Returns (y [B, S, H, Dv], final state)."""
    S = r.shape[1]
    C = min(chunk, S)
    if not (S % C == 0 and S > 1):
        return _wkv_chunk(r, k, v, lw, u, s0)
    ys, s = [], s0
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        y, s = _wkv_chunk(r[:, sl], k[:, sl], v[:, sl], lw[:, sl], u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def rwkv_time_mix(cfg: LMConfig, p: dict, x: torch.Tensor,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B, S, d]. state (decode): {"wkv": [B, H, Dk, Dv], "shift": [B, d]}.

    Under tensor parallelism where the model axis divides the heads
    (``tensor_parallel.rwkv_heads``) a rank runs its own heads: the
    column-parallel ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` (its storage
    slices), the decay, ``u``, the scan, the group norm and the gate on
    them, ``w_o``'s rows for them and :func:`tensor_parallel.reduce_out`;
    its ``wkv`` state holds those heads.  Otherwise the mix is whole."""
    f32 = torch.float32
    B, S, d = x.shape
    H = cfg.num_heads
    Dh = d // H
    ax = tp.active(cfg)
    span = tp.rwkv_heads(cfg, ax)
    last = state["shift"] if state is not None else None
    xs = _token_shift(x, last)
    xr, xk, xv, xg, xw = (_mix(x, xs, p["mu"][i]) for i in range(5))
    proj = ("w_r", "w_k", "w_v", "w_g")
    if span is None:
        w = {n: tp.whole(p[n], -1, d, ax) for n in proj}
        u, ln, w_o, cols = p["u"], p["ln_scale"], p["w_o"], None
    else:
        lo, hi = span[0] * Dh, span[1] * Dh
        xr, xk, xv, xg = (tp.copy_in(t, ax.group) for t in (xr, xk, xv, xg))
        w = {n: tp.take(p[n], -1, d, lo, hi, ax) for n in proj}
        u = tp.take(p["u"], -2, H, *span, ax)
        ln = tp.take(p["ln_scale"], -1, d, lo, hi, ax)
        w_o = tp.take(p["w_o"], -2, d, lo, hi, ax)
        cols = (lo, hi, ax)
        H = span[1] - span[0]
    r = (xr @ w["w_r"].to(x.dtype)).reshape(B, S, H, Dh).to(f32)
    k = (xk @ w["w_k"].to(x.dtype)).reshape(B, S, H, Dh).to(f32)
    v = (xv @ w["w_v"].to(x.dtype)).reshape(B, S, H, Dh).to(f32)
    g = F.silu(xg @ w["w_g"].to(x.dtype))
    lw = _decays(p, xw, cols).reshape(B, S, H, Dh)
    u = u.to(f32)

    s0 = state["wkv"].to(f32) if state is not None else \
        torch.zeros((B, H, Dh, Dh), dtype=f32, device=x.device)
    y, s_fin = _wkv_scan(r, k, v, lw, u, s0, cfg.chunk_size)

    # per-head group norm, gate, output projection
    yn = L.rms_norm(y.reshape(B * S * H, Dh),
                    torch.zeros((Dh,), dtype=f32, device=x.device),
                    cfg.norm_eps)
    y = (yn.reshape(B, S, H * Dh) * ln.to(f32)).to(x.dtype) * g
    out = y @ w_o.to(x.dtype)
    if span is not None:
        out = tp.reduce_out(out, [ax.group])
    new_state = None
    if state is not None:
        new_state = {"wkv": s_fin.to(state["wkv"].dtype), "shift": x[:, -1]}
    return out, new_state


def rwkv_channel_mix(cfg: LMConfig, p: dict, x: torch.Tensor,
                     state: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The channel mix; under tensor parallelism where the model axis
    divides ``d_ff``, ``w_k`` column-parallel over it (its storage
    slice), ``w_v`` (gathered whole) taken by its rows for the rank's
    ``d_ff`` slice and :func:`tensor_parallel.reduce_out`; ``w_r`` whole."""
    last = state["shift"] if state is not None else None
    xs = _token_shift(x, last)
    xk = _mix(x, xs, p["mu"][0])
    xr = _mix(x, xs, p["mu"][1])
    ax, ff = tp.active(cfg), cfg.d_ff
    split = ax is not None and ff % ax.size == 0
    if split:
        lo, hi = ax.slice_of(ff)
        xk = tp.copy_in(xk, ax.group)
        w_k = tp.take(p["w_k"], -1, ff, lo, hi, ax)
        w_v = tp.take(p["w_v"], -2, ff, lo, hi, ax)
    else:
        w_k, w_v = tp.whole(p["w_k"], -1, ff, ax), p["w_v"]
    k = torch.square(torch.relu(xk @ w_k.to(x.dtype)))
    kv = k @ w_v.to(x.dtype)
    if split:
        kv = tp.reduce_out(kv, [ax.group])
    out = torch.sigmoid(xr @ p["w_r"].to(x.dtype)) * kv
    new_state = {"shift": x[:, -1]} if state is not None else None
    return out, new_state


# --------------------------------------------------------------------------
# sequential oracle
# --------------------------------------------------------------------------

def wkv_sequential(r, k, v, lw, u, state):
    """Step-by-step WKV recurrence; same signature as _wkv_chunk."""
    ys, s = [], state
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]             # [B, H, D*]
        w = torch.exp(lw[:, t])
        kv = torch.einsum("bhi,bhj->bhij", kt, vt)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               s + u[None, :, :, None] * kv))
        s = s * w[..., None] + kv
    return torch.stack(ys, dim=1), s
