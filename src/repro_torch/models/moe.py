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

The reference's two ``shard_map`` variants run here as one process per
rank of a ``DeviceMesh``, on the rank's block of the batch, with explicit
collectives on the mesh's sub-groups (``dist/comm.py``'s host-staging
rule under gloo): :func:`moe_forward_shardmap` (experts, or virtual
experts, over 'model'; one sum of the outputs over 'model') and
:func:`moe_forward_shardmap_ep` (experts over the batch axes, the FFN dim
over 'model'; two token all-to-alls over the batch axes).  ``moe_forward``
dispatches to them under ``sharding_ctx.set_shardmap_moe``, as the
reference's does.  ``moe_forward_dense_fallback`` is the oracle.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import layers as L
from .config import LMConfig
from .sharding_ctx import constrain, get_shardmap_moe
from .tensor_parallel import copy_in, reduce_out


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


def _slot_tables(key: torch.Tensor, flat_t: torch.Tensor,
                 flat_w: torch.Tensor, n_keys: int, n_real: int, C: int,
                 T: int):
    """Slot tables of a capacity-``C`` dispatch of (token, choice) pairs
    with bucket ``key`` in ``[0, n_keys)``; buckets ``>= n_real`` are
    dropped.  Returns (tok [n_real*C] int64, the token of each slot or
    ``T`` for an empty one; w [n_real*C], its router weight or 0; the
    per-bucket counts).

    A stable sort of the token-major list by key, as
    ``jnp.argsort(stable=True)`` orders it, decides which pairs a full
    bucket drops.  Dropped pairs all write the pad slot ``n_real*C`` of
    a buffer one longer than the table; it is sliced off and never
    read."""
    dev = key.device
    _, order = torch.sort(key, stable=True)
    se, st, sw = key[order], flat_t[order], flat_w[order]
    # per-bucket counts as bincount's, with a shape that does not depend
    # on the data (fake tensors and the accountant run through it)
    counts = torch.zeros((n_keys,), dtype=torch.int64,
                         device=dev).scatter_add_(0, key,
                                                  torch.ones_like(key))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(key.shape[0], device=dev) - offsets[se]
    keep = (se < n_real) & (pos < C)
    slot = torch.where(keep, se * C + pos, n_real * C)
    tok = torch.full((n_real * C + 1,), T, dtype=torch.int64, device=dev)
    tok[slot] = torch.where(keep, st, T)
    w = torch.zeros((n_real * C + 1,), dtype=flat_w.dtype, device=dev)
    w[slot] = torch.where(keep, sw, torch.zeros_like(sw))
    return tok[:n_real * C], w[:n_real * C], counts


def _flat_choices(top_p: torch.Tensor, top_e: torch.Tensor, dtype):
    """The token-major (expert, token, weight) lists of the top-k
    choices."""
    T, K = top_e.shape
    return (top_e.reshape(T * K),
            torch.arange(T, device=top_e.device).repeat_interleave(K),
            top_p.reshape(T * K).to(dtype))


def dispatch(cfg: LMConfig, top_p: torch.Tensor, top_e: torch.Tensor,
             C: int, dtype):
    """The slot tables of a capacity-``C`` dispatch: (tok_for_slot [E*C]
    int64, the token of each expert slot or T for an empty one;
    w_for_slot [E*C] in ``dtype``, its router weight or 0; the number of
    (token, choice) pairs dropped at capacity)."""
    T, K = top_e.shape
    E = cfg.moe.num_experts
    flat_e, flat_t, flat_w = _flat_choices(top_p, top_e, dtype)
    tok, w, counts = _slot_tables(flat_e, flat_t, flat_w, E, E, C, T)
    return tok, w, T * K - torch.clamp_max(counts, C).sum()


def _aux_loss(cfg: LMConfig, probs: torch.Tensor, top_e: torch.Tensor):
    """Switch-style load-balancing loss of one batch of tokens."""
    T, K = top_e.shape
    E = cfg.moe.num_experts
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32,
                     device=probs.device).index_add_(
        0, top_e.reshape(-1),
        torch.full((T * K,), 1.0 / (T * K), dtype=torch.float32,
                   device=probs.device))
    return cfg.moe.router_aux_weight * E * torch.sum(me * ce)


def _combine(out: torch.Tensor, w: torch.Tensor, tok: torch.Tensor, T: int
             ) -> torch.Tensor:
    """The weighted scatter-add of expert slots ``out`` [slots, d] back
    to their tokens: [T, d].

    index_add_ on the card adds by atomics in no fixed order; with
    top_k = 2 every real row receives at most two terms onto 0, and
    round(round(0 + a) + b) == round(round(0 + b) + a) in any dtype,
    so the sum does not depend on their order.  The pad row T collects
    every empty slot in any order; it is sliced off."""
    flat_out = out.reshape(-1, out.shape[-1]) * w[:, None]
    return torch.zeros((T + 1, out.shape[-1]), dtype=out.dtype,
                       device=out.device).index_add_(0, tok, flat_out)[:T]


def _ffn(cfg: LMConfig, expert_in, wg, wu, wd) -> torch.Tensor:
    """The batched expert GLU FFN: three ``torch.bmm`` over the expert
    axis."""
    h = L._act(cfg, torch.bmm(expert_in, wg)) * torch.bmm(expert_in, wu)
    return torch.bmm(h, wd)


def moe_forward(cfg: LMConfig, p: dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar f32).

    Under ``set_shardmap_moe((mesh, batch_axes, model_axis))`` ``x`` is
    this rank's block of the batch and the work goes to the
    expert-parallel variant when the experts split over the batch axes
    and the FFN dim over 'model', else to the model-parallel one."""
    ctx = get_shardmap_moe()
    if ctx is not None:
        from ..launch.mesh import axis_size
        mesh, batch_axes, model_axis = ctx
        n_data = math.prod(axis_size(mesh, a) for a in batch_axes)
        if n_data > 1 and cfg.moe.num_experts % n_data == 0 and \
                cfg.moe.d_ff % axis_size(mesh, model_axis) == 0:
            return moe_forward_shardmap_ep(cfg, p, x, *ctx)
        return moe_forward_shardmap(cfg, p, x, *ctx)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E = m.num_experts
    C = capacity(cfg, T)
    xf = x.reshape(T, d)

    # ---- routing (f32) and the load-balancing aux loss ----
    probs, top_p, top_e = route(cfg, p, xf)
    aux = _aux_loss(cfg, probs, top_e)

    # ---- sort-based dispatch ----
    tok_for_slot, w_for_slot, _ = dispatch(cfg, top_p, top_e, C, x.dtype)
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    expert_in = constrain(xpad[tok_for_slot].reshape(E, C, d), "moe_ecd")

    # ---- batched expert FFN (weights cast on every call, as the
    # reference casts them) ----
    expert_out = _ffn(cfg, expert_in,
                      constrain(p["w_gate"].to(x.dtype), "moe_w_in"),
                      constrain(p["w_up"].to(x.dtype), "moe_w_in"),
                      constrain(p["w_down"].to(x.dtype), "moe_w_out"))
    expert_out = constrain(expert_out, "moe_ecd")            # [E, C, d]

    # ---- weighted combine ----
    y = _combine(expert_out, w_for_slot, tok_for_slot, T)
    return y.reshape(B, S, d), aux


# --------------------------------------------------------------------------
# explicit-collective variants (one process per mesh rank)
# --------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal blocks; its own inverse, so the
    backward pass sends the gradient blocks back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        from ..dist.comm import all_to_all
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        from ..dist.comm import all_to_all
        return all_to_all(g, ctx.group), None


def _whole(w: torch.Tensor) -> torch.Tensor:
    """A weight as one local tensor: a ``DTensor`` is gathered
    (``launch.sharding.gather_leaf``)."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import gather_leaf
    return gather_leaf(w) if isinstance(w, DTensor) else w


def _batch_group(mesh, batch_axes):
    """(the process group over the batch axes flattened row-major, its
    size, this rank's index in it)."""
    if len(batch_axes) == 1:
        sub = mesh[batch_axes[0]]
    else:
        sub = mesh[tuple(batch_axes)]._flatten()
    return sub.get_group(), sub.size(), sub.get_local_rank()


def _route_local(cfg: LMConfig, p: dict, xf: torch.Tensor, mesh,
                 batch_axes):
    """Routing of this rank's tokens, the aux loss meaned over the batch
    axes (the reference's ``pmean``)."""
    from ..launch.mesh import axis_size
    probs, top_p, top_e = route(cfg, {"router": _whole(p["router"])}, xf)
    aux = _aux_loss(cfg, probs, top_e)
    groups = [mesh.get_group(a) for a in batch_axes]
    n = math.prod(axis_size(mesh, a) for a in batch_axes)
    return top_p, top_e, reduce_out(aux, groups, 1.0 / n)


def _model_partial(xf, top_p, mesh, model_axis):
    """The tokens and combine weights as the expert path reads them: each
    model rank's experts (or FFN slices) give it part of their gradient,
    which ``copy_in`` sums over 'model'.  The router's other input, the
    aux loss, is the same on every model rank and stays unsummed."""
    group = mesh.get_group(model_axis)
    return copy_in(xf, group), copy_in(top_p, group)


def moe_forward_shardmap(cfg: LMConfig, p: dict, x: torch.Tensor, mesh,
                         batch_axes, model_axis
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-parallel MoE on this rank's block ``x`` [B_loc, S, d] of the
    batch -> (its y block, the aux loss meaned over the batch axes).

    Activations are replicated over the model axis within each batch
    block, so every model rank buckets, with no communication, the
    tokens routed to the experts it owns; the one collective is the sum
    of the combined outputs over 'model'.  Experts map onto the model
    axis as ``V = max(E, n_model)`` virtual experts: E a multiple of
    n_model shards whole experts; E < n_model splits each expert's FFN
    dim into ``n_model / E`` column slices, whose partial
    down-projections the same sum recombines.  Capacity is per (rank,
    expert): ``C = max(8, ceil(cf * K * T_loc / E / 8) * 8)``.  Weights
    are whole tensors (a ``DTensor`` is gathered); each rank slices its
    own."""
    from ..launch.mesh import axis_size
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    n_model = axis_size(mesh, model_axis)
    j = mesh.get_local_rank(model_axis)
    T = B * S
    if E % n_model == 0:
        split, v_loc = 1, E // n_model
    else:
        if n_model % E:
            raise ValueError(f"{E} experts on a model axis of {n_model}")
        split, v_loc = n_model // E, 1
    if m.d_ff % split:
        raise ValueError(f"d_ff {m.d_ff} does not split in {split}")
    ff_v = m.d_ff // split
    C = max(8, int(math.ceil(m.capacity_factor * K * T / E / 8)) * 8)

    wg, wu, wd = (_whole(p[k]) for k in ("w_gate", "w_up", "w_down"))
    if split == 1:
        e0 = j * v_loc
        wg, wu, wd = wg[e0:e0 + v_loc], wu[e0:e0 + v_loc], wd[e0:e0 + v_loc]
    else:
        e, q = j // split, j % split
        cols = slice(q * ff_v, (q + 1) * ff_v)
        wg, wu, wd = wg[e:e + 1, :, cols], wu[e:e + 1, :, cols], \
            wd[e:e + 1, cols, :]
    # the rank's slices, cast on every call as moe_forward casts
    wg, wu, wd = wg.to(x.dtype), wu.to(x.dtype), wd.to(x.dtype)

    xf = x.reshape(T, d)
    top_p, top_e, aux = _route_local(cfg, p, xf, mesh, batch_axes)
    xf, top_p = _model_partial(xf, top_p, mesh, model_axis)
    flat_e, flat_t, flat_w = _flat_choices(top_p, top_e, x.dtype)
    if split == 1:
        local_e = flat_e - e0
        mine = (flat_e >= e0) & (flat_e < e0 + v_loc)
    else:
        local_e = torch.zeros_like(flat_e)
        mine = flat_e == j // split
    key = torch.where(mine, local_e, v_loc)
    tok, w_slot, _ = _slot_tables(key, flat_t, flat_w, v_loc + 1, v_loc, C,
                                  T)
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    out = _ffn(cfg, xpad[tok].reshape(v_loc, C, d), wg, wu, wd)
    y = _combine(out, w_slot, tok, T)
    y = reduce_out(y, [mesh.get_group(model_axis)])
    return y.reshape(B, S, d), aux


def moe_forward_shardmap_ep(cfg: LMConfig, p: dict, x: torch.Tensor, mesh,
                            batch_axes, model_axis
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank's block ``x`` [B_loc, S, d]:
    experts over the batch axes, the FFN dim over 'model' -- the
    GShard / DeepSpeed all-to-all pattern.

      1. each batch rank buckets its tokens by destination rank (the
         owner of the routed expert) into [n_data, E_loc, C, d];
      2. an all-to-all over the batch axes delivers [n_data(source),
         E_loc, C, d];
      3. the local batched FFN on the rank's [E_loc, ff / n_model] slice;
      4. the reverse all-to-all returns the outputs to each token's home
         rank, which combines them with its slot -> token map;
      5. a sum over 'model' adds the ff slices.

    Requires E % n_data == 0 and d_ff % n_model == 0; capacity is per
    (source rank, expert), as in :func:`moe_forward_shardmap`."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    from ..launch.mesh import axis_size
    group, n_data, r = _batch_group(mesh, batch_axes)
    n_model = axis_size(mesh, model_axis)
    j = mesh.get_local_rank(model_axis)
    if E % n_data or m.d_ff % n_model:
        raise ValueError(f"{E} experts / d_ff {m.d_ff} on a "
                         f"{n_data} x {n_model} mesh")
    E_loc, ff_loc = E // n_data, m.d_ff // n_model
    T = B * S
    C = max(8, int(math.ceil(m.capacity_factor * K * T / E / 8)) * 8)
    es, cols = slice(r * E_loc, (r + 1) * E_loc), \
        slice(j * ff_loc, (j + 1) * ff_loc)
    wg = _whole(p["w_gate"])[es, :, cols].to(x.dtype)
    wu = _whole(p["w_up"])[es, :, cols].to(x.dtype)
    wd = _whole(p["w_down"])[es, cols, :].to(x.dtype)

    xf = x.reshape(T, d)
    top_p, top_e, aux = _route_local(cfg, p, xf, mesh, batch_axes)
    xf, top_p = _model_partial(xf, top_p, mesh, model_axis)
    flat_e, flat_t, flat_w = _flat_choices(top_p, top_e, x.dtype)
    # slots (destination rank, local expert, c), flattened
    tok, w_slot, _ = _slot_tables(flat_e, flat_t, flat_w, E, E, C, T)
    xpad = torch.cat([xf, torch.zeros((1, d), dtype=x.dtype,
                                      device=x.device)])
    send = xpad[tok].reshape(n_data, E_loc * C, d)
    recv = _AllToAll.apply(send, group)              # [n_data(src), ...]
    expert_in = recv.reshape(n_data, E_loc, C, d).transpose(0, 1) \
        .reshape(E_loc, n_data * C, d)
    out = _ffn(cfg, expert_in, wg, wu, wd)           # [E_loc, n_data*C, d]
    back = out.reshape(E_loc, n_data, C, d).transpose(0, 1) \
        .reshape(n_data, E_loc * C, d)
    ret = _AllToAll.apply(back, group)               # my slots again
    y = _combine(ret, w_slot, tok, T)
    y = reduce_out(y, [mesh.get_group(model_axis)])
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
