"""Mamba2 (SSD) blocks for the zamba2 hybrid backbone.

State-space recurrence with scalar-per-head decay:

    h_t = exp(dt_t * A_h) h_{t-1} + (dt_t * B_t) (x) x_t
    y_t = C_t . h_t + D_h * x_t

evaluated chunkwise (the SSD algorithm) as in the reference
(``repro.models.ssm``): scalar decays make the intra-chunk term a
[C, C] masked score matrix per head -- exp of log-decay *differences*,
so no overflow.  A Python loop over the ``S // chunk_size`` chunks
carries the [B, H, d_state, d_head] state (the reference's
``lax.scan``); decode is the O(1) update.

``ssd_sequential`` is the exact oracle used by the tests and the card
check.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import layers as L
from .config import LMConfig

# the reference's finite mask value: it enters exp(), which gives 0
NEG_INF = -1e30


def mamba_params(cfg: LMConfig, gen, device, lead=()) -> dict:
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    pd = L.dtype_of(cfg.param_dtype)
    f32 = torch.float32
    conv_ch = di + 2 * ns
    return {
        # in_proj -> [z, xc, B, C, dt]
        "w_in": L.dense_init(gen, (*lead, d, 2 * di + 2 * ns + nh), device,
                             pd),
        "conv_w": L.normal((*lead, cfg.conv_width, conv_ch), gen, device,
                           0.1, pd),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=pd, device=device),
        "a_log": torch.zeros((*lead, nh), dtype=f32, device=device),
        "dt_bias": torch.full((*lead, nh), -2.0, dtype=f32, device=device),
        "d_skip": torch.ones((*lead, nh), dtype=f32, device=device),
        "w_out": L.dense_init(gen, (*lead, di, d), device, pd),
        "gn_scale": torch.ones((*lead, di), dtype=pd, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: [B, S, ch], w: [W, ch].

    state (decode): [B, W-1, ch] trailing inputs. Returns (y, new_state)."""
    B, S, ch = x.shape
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((B, W - 1, ch), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # [B, S+W-1, ch]
    y = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(W))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(W - 1):] if state is not None else None
    return y, new_state


def _ssd_chunk(xh, Bm, Cm, dt, la, state, score_dtype=torch.float32):
    """One SSD chunk.

    xh: [B, C, H, P] values; Bm/Cm: [B, C, N] in/out mix; dt: [B, C, H];
    la: [B, C, H] log decay (<0); state: [B, H, N, P].
    ``score_dtype``: buffer dtype of the [B, C, C, H] score tensor; the
    products and sums stay float32 (the reference's
    ``preferred_element_type``).  Returns (y [B, C, H, P], new state)."""
    f32 = torch.float32
    Lc = torch.cumsum(la, dim=1)                      # [B, C, H] inclusive
    # intra-chunk: scores[t,s] = exp(L_t - L_s) * (C_t.B_s) * dt_s, s <= t
    diff = Lc[:, :, None, :] - Lc[:, None, :, :]      # [B, C, C, H]
    C_len = xh.shape[1]
    mask = torch.tril(torch.ones((C_len, C_len), dtype=torch.bool,
                                 device=xh.device))
    diff = torch.where(mask[None, :, :, None], diff, NEG_INF)
    cb = torch.einsum("btn,bsn->bts", Cm, Bm)         # [B, C, C]
    scores = (torch.exp(diff) * cb[..., None] * dt[:, None, :, :]
              ).to(score_dtype)
    y = torch.einsum("btsh,bshp->bthp", scores.to(f32),
                     xh.to(score_dtype).to(f32))
    # inter-chunk: y += exp(L_t) C_t . h0
    y = y + torch.einsum("bth,btn,bhnp->bthp", torch.exp(Lc), Cm, state)
    # state update
    decay_all = torch.exp(Lc[:, -1])                  # [B, H]
    rem = torch.exp(Lc[:, -1][:, None] - Lc)          # [B, C, H]
    upd = torch.einsum("bsh,bsn,bshp->bhnp", rem * dt, Bm, xh)
    new_state = state * decay_all[:, :, None, None] + upd
    return y, new_state


def _ssd_scan(xh, Bm, Cm, dt, la, s0, chunk: int, score_dtype):
    """``_ssd_chunk`` over the sequence in chunks of ``chunk``, the state
    carried across (one chunk over all of it when ``chunk`` does not
    divide S, or S == 1).  Returns (y [B, S, H, P], final state)."""
    S = xh.shape[1]
    C = min(chunk, S)
    if not (S % C == 0 and S > 1):
        return _ssd_chunk(xh, Bm, Cm, dt, la, s0, score_dtype=score_dtype)
    ys, s = [], s0
    for c in range(S // C):
        sl = slice(c * C, (c + 1) * C)
        y, s = _ssd_chunk(xh[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl],
                          la[:, sl], s, score_dtype=score_dtype)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def mamba_forward(cfg: LMConfig, p: dict, x: torch.Tensor,
                  state: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B, S, d]. state (decode): {"ssm": [B, H, N, P], "conv": [B, W-1, ch]}.

    Returns (out [B, S, d], the new state, or None without one)."""
    f32 = torch.float32
    B, S, d = x.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    P = di // nh
    proj = x @ p["w_in"].to(x.dtype)
    z, xc, Bm, Cm, dt = torch.split(proj, [di, di, ns, ns, nh], dim=-1)
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        state["conv"] if state is not None else None)
    conv_out = F.silu(conv_out)
    xc, Bm, Cm = torch.split(conv_out, [di, ns, ns], dim=-1)

    # jax.nn.softplus is logaddexp(x, 0)
    dt = torch.logaddexp(dt.to(f32) + p["dt_bias"],
                         torch.zeros((), dtype=f32, device=x.device))
    A = -torch.exp(p["a_log"])                                   # [H] < 0
    la = torch.clamp(dt * A[None, None, :], -30.0, -1e-6)        # log decay
    xh = xc.to(f32).reshape(B, S, nh, P)
    Bm = Bm.to(f32)
    Cm = Cm.to(f32)

    s0 = state["ssm"].to(f32) if state is not None else \
        torch.zeros((B, nh, ns, P), dtype=f32, device=x.device)
    y, s_fin = _ssd_scan(xh, Bm, Cm, dt, la, s0, cfg.chunk_size,
                         L.dtype_of(cfg.logit_dtype))

    y = y + p["d_skip"][None, None, :, None] * xh                # skip
    y = y.reshape(B, S, di).to(x.dtype)
    # gated RMSNorm (mamba2) then out projection
    y = L.rms_norm(y * F.silu(z), p["gn_scale"].to(f32) - 1.0, cfg.norm_eps)
    out = y @ p["w_out"].to(x.dtype)
    new_state = None
    if state is not None:
        new_state = {"ssm": s_fin.to(state["ssm"].dtype), "conv": new_conv}
    return out, new_state


# --------------------------------------------------------------------------
# sequential oracle
# --------------------------------------------------------------------------

def ssd_sequential(xh, Bm, Cm, dt, la, state):
    """Step-by-step SSD recurrence; same contract as _ssd_chunk."""
    ys, s = [], state
    for t in range(xh.shape[1]):
        a = torch.exp(la[:, t])                                  # [B, H]
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], xh[:, t])
        s = s * a[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], s))
    return torch.stack(ys, dim=1), s
