"""Mixture-of-Experts FFN (mixtral 8e top-2, arctic 128e top-2 + dense).

The reference's (``repro.models.moe``) single-device path: sort-based
(MegaBlocks-style) dispatch with a static per-expert capacity rather
than a [T, E, C] one-hot dispatch product.

  1. top-k routing (f32 softmax over router logits),
  2. flat (token, choice) list sorted by expert id; position-in-expert by
     rank arithmetic,
  3. gather tokens into a dense [E, C, d] buffer (capacity-dropped tokens
     fall into a zero row),
  4. batched expert GLU FFN: three ``torch.bmm`` over the E axis,
  5. weighted scatter-add back to token positions.

Load-balancing auxiliary loss follows the switch-transformer formulation.
The reference's two ``shard_map`` variants (expert- and model-parallel
over a mesh) have no counterpart yet: they need collectives over several
cards (ROADMAP A18).  ``moe_forward_dense_fallback`` is the oracle.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import layers as L
from .config import LMConfig


def moe_params(cfg: LMConfig, gen, device, lead=()) -> dict:
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.d_ff
    pd = L.dtype_of(cfg.param_dtype)
    return {
        "router": L.dense_init(gen, (*lead, d, E), device, pd, scale=0.02),
        "w_gate": L.dense_init(gen, (*lead, E, d, ff), device, pd),
        "w_up": L.dense_init(gen, (*lead, E, d, ff), device, pd),
        "w_down": L.dense_init(gen, (*lead, E, ff, d), device, pd),
    }


def capacity(cfg: LMConfig, num_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * m.top_k * num_tokens / m.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def route(cfg: LMConfig, p: dict, xf: torch.Tensor):
    """Router of tokens ``xf`` [T, d]: (probs [T, E] f32, top_p [T, K]
    f32 renormalised, top_e [T, K] int64).

    ``jax.lax.top_k`` puts the lower expert first on equal values;
    ``torch.topk`` promises no order, so the top k come from a stable
    descending sort."""
    logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.moe.top_k
    top_p, top_e = top_p[:, :K], top_e[:, :K]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def dispatch(cfg: LMConfig, top_p: torch.Tensor, top_e: torch.Tensor,
             C: int, dtype):
    """The slot tables of a capacity-``C`` dispatch: (tok_for_slot [E*C]
    int64, the token of each expert slot or T for an empty one;
    w_for_slot [E*C] in ``dtype``, its router weight or 0; the number of
    (token, choice) pairs dropped at capacity).

    A stable sort of the token-major (token, choice) list by expert, as
    ``jnp.argsort(stable=True)`` orders it, decides which tokens a full
    expert drops.  Dropped pairs all write the pad slot E*C of a buffer
    one longer than the table; it is sliced off and never read."""
    T, K = top_e.shape
    E = cfg.moe.num_experts
    dev = top_e.device
    flat_e = top_e.reshape(T * K)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    flat_w = top_p.reshape(T * K).to(dtype)
    _, order = torch.sort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # per-expert counts as bincount's, with a shape that does not depend
    # on the data (fake tensors and the accountant run through it)
    counts = torch.zeros((E,), dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(T * K, device=dev) - offsets[se]
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)
    tok_for_slot = torch.full((E * C + 1,), T, dtype=torch.int64,
                              device=dev)
    tok_for_slot[slot] = torch.where(keep, st, T)
    w_for_slot = torch.zeros((E * C + 1,), dtype=dtype, device=dev)
    w_for_slot[slot] = torch.where(keep, sw, torch.zeros_like(sw))
    dropped = T * K - torch.clamp_max(counts, C).sum()
    return tok_for_slot[:E * C], w_for_slot[:E * C], dropped


def moe_forward(cfg: LMConfig, p: dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    C = capacity(cfg, T)
    xf = x.reshape(T, d)

    # ---- routing (f32) ----
    probs, top_p, top_e = route(cfg, p, xf)

    # load-balancing aux loss (switch-style)
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, top_e.reshape(-1),
        torch.full((T * K,), 1.0 / (T * K), dtype=torch.float32,
                   device=x.device))
    aux = m.router_aux_weight * E * torch.sum(me * ce)

    # ---- sort-based dispatch ----
    tok_for_slot, w_for_slot, _ = dispatch(cfg, top_p, top_e, C, x.dtype)
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    expert_in = xpad[tok_for_slot].reshape(E, C, d)

    # ---- batched expert FFN (weights cast on every call, as the
    # reference casts them) ----
    wg = p["w_gate"].to(x.dtype)
    wu = p["w_up"].to(x.dtype)
    wd = p["w_down"].to(x.dtype)
    h = L._act(cfg, torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wu)
    expert_out = torch.bmm(h, wd)                              # [E, C, d]

    # ---- weighted combine ----
    # index_add_ on the card adds by atomics in no fixed order; with
    # top_k = 2 every real row receives at most two terms onto 0, and
    # round(round(0 + a) + b) == round(round(0 + b) + a) in any dtype,
    # so the sum does not depend on their order.  The pad row T collects
    # every empty slot in any order; it is sliced off.
    flat_out = expert_out.reshape(E * C, d) * w_for_slot[:, None]
    y = torch.zeros((T + 1, d), dtype=x.dtype, device=x.device).index_add_(
        0, tok_for_slot, flat_out)[:T]
    return y.reshape(B, S, d), aux


def moe_forward_dense_fallback(cfg: LMConfig, p: dict, x: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: computes every expert densely and mixes by router weights.

    O(T * E * ff) compute -- only for checks of the sparse dispatch path."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    probs, top_p, top_e = route(cfg, p, xf)
    w = torch.zeros_like(probs).scatter_(1, top_e, top_p)     # [T, E]
    h = L._act(cfg, torch.einsum("td,edf->tef", xf,
                                 p["w_gate"].to(x.dtype))) * \
        torch.einsum("td,edf->tef", xf, p["w_up"].to(x.dtype))
    out = torch.einsum("tef,efd->ted", h, p["w_down"].to(x.dtype))
    y = torch.einsum("ted,te->td", out, w.to(x.dtype))
    return y.reshape(B, S, d), torch.zeros((), dtype=torch.float32,
                                           device=x.device)
