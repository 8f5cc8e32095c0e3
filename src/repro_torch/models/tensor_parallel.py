"""Tensor-parallel (Megatron-style) compute on a mesh's model axis.

The mesh paths store the trunk FSDP x TP (``launch/sharding.py``:
``wq`` / ``wk`` / ``wv``, ``w_gate`` / ``w_up`` and ``head`` split their
columns over 'model', ``wo``, ``w_down`` and ``embed`` their rows).  Under
``sharding_ctx.tensor_parallel((mesh, model_axis))`` a rank computes on
its own slice of every dim the spec shards over the model axis, and whole
where the spec leaves the dim whole, as GSPMD partitions the reference's
program.  The model code stays mesh-agnostic: it asks :func:`active` and
reads the split from its weights' shapes (a dim the rank holds a slice of
is ``1 / M`` of its whole size).

* **The conjugate pair.** :func:`copy_in` (identity forward, a sum over the
  model group backward) at the input of every column-parallel product,
  :func:`reduce_out` (a sum forward, identity backward) at the output of
  every row-parallel one.  The residual stream stays whole and equal on the
  model ranks of a batch block, and so does its gradient.
* **Attention** where ``M | H``: rank ``r`` computes q heads
  ``[r H / M, (r + 1) H / M)`` and the KV heads they read
  (:func:`attn_heads`).  Where ``M | KV`` those are the rank's own columns
  of ``wk`` / ``wv``; where not, the columns are gathered over the model
  axis (backward: the sum over the ranks, then the rank's slice) and only
  the KV heads read are projected.  ``wo`` is row-parallel.  Where ``M``
  does not divide ``H``, or a rank's q heads would not read their KV
  heads as ``i // q_per_kv`` (neither ``M | KV`` nor one KV head a rank),
  attention is computed whole on every rank: its weights are gathered
  (backward: the rank's slice of a gradient every rank computes alike).
* **MLP**: ``w_gate`` / ``w_up`` column-parallel over ``d_ff``,
  ``w_down`` row-parallel.
* **Embedding and head**: vocab-parallel where ``M | V``.  The lookup
  writes zeros for the tokens outside the rank's vocab range before
  :func:`reduce_out`; the logits are the rank's vocab slice;
  :func:`vocab_parallel_ce` takes the max over the vocab by an
  ``all_reduce(MAX)``, the sum of ``exp`` and the target logit by
  :func:`reduce_out`.
* **A sequence-sharded cache** (``M`` does not divide ``KV``: its
  sequence dim is sharded over 'model', or over ('data', 'model') for a
  batch the batch axes do not split): :class:`SeqShard` describes the
  rank's shard, positions ``[r S_c / G, (r + 1) S_c / G)`` of the
  group's ``G`` ranks.  The rank writes the positions it owns of every
  KV head (``wk`` / ``wv`` whole on it, :func:`attn_weights` with
  ``all_kv``), and a decode step's attention is split over the shards:
  local logits, then the row max, the sum of ``exp`` and ``P V`` each
  summed by :meth:`SeqShard.all_reduce` (``layers._masked_decode_attn``),
  as XLA partitions the reference's decode attention over the same
  cache.  Where the rank's q heads are split too, q is gathered over
  'model' first (:func:`gather_heads`) and the rank keeps its own heads
  of the result.
* **rwkv6** where ``M | H``: the time mix's ``w_r`` / ``w_k`` / ``w_v``
  / ``w_g`` column-parallel over heads, the decay, ``u``, the WKV scan,
  the group norm and the gate on the rank's heads, ``w_o`` (whole in
  storage) taken by its rows for them; the channel mix's ``w_k``
  column-parallel over ``d_ff`` and ``w_v`` (stored split over ``d``)
  taken whole by its ``d_ff`` rows, ``w_r`` whole (:func:`rwkv_heads`).
* **whisper**: the encoder's and the decoder's attention (self and
  cross) and MLPs split as the dense trunk's; the cross-attention K / V
  of the cache hold the rank's KV heads.  **zamba2**: the shared block
  splits as the dense trunk's; mamba is whole (no rule shards it over
  'model').

The MoE experts and router compute on gathered weights (the two
explicit-collective MoE variants slice whole weights themselves).
:func:`local_params` is the local view a step computes on: each
``DTensor`` leaf gathered over every mesh dim but the model axis, whose
slice it keeps where :func:`keeps_model_slice` says so.

Every collective goes through ``dist/comm.py`` (gloo stages through the
host).  ``SENT`` counts the bytes this rank sends by move: ``reduce``
(the sums of both halves of the pair), ``gather`` (the weights and logits
gathered over the model axis, and the sums of their backward), ``max``
(the CE's maximum), ``combine`` (a split decode attention's sums and
its q gather); set an entry to 0 to start a count.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding_ctx import get_shardmap_moe, get_tensor_parallel

# the param leaves a step keeps local on the model axis, per family: the
# embedding and the head, and the leaves whose compute splits (the rest
# is gathered whole); FAMILIES are the families that split their compute
_TRUNK = r"\['(attn|mlp)'\]\['\w+'\]$"
_KEEPS = {
    "dense": _TRUNK, "vlm": _TRUNK, "moe": _TRUNK,
    "hybrid": _TRUNK,                       # the shared block
    "encdec": r"\['(attn|xattn|mlp)'\]\['\w+'\]$",
    "rwkv": r"\['tm'\]\['w_[rkvg]'\]$|\['cm'\]\['w_k'\]$",
}
FAMILIES = tuple(_KEEPS)
MODEL_AXIS = "model"      # the mesh axis the steps split their compute over
_EXPERT = re.compile(r"\['moe'\]\['w_(gate|up|down)'\]$")
SENT = {"reduce": 0, "gather": 0, "max": 0, "combine": 0}


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """This rank's place on the model axis: its process group, the
    axis's size ``M`` and the rank's index on it."""

    group: object
    size: int
    rank: int

    def slice_of(self, n: int) -> Tuple[int, int]:
        """The rank's ``[lo, hi)`` of a dim of ``n`` split in ``M``."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def active(cfg) -> Optional[ModelAxis]:
    """The model axis a step of ``cfg`` splits its compute over, or None:
    no context installed, a model axis of 1, or a family outside
    :data:`FAMILIES`."""
    ctx = get_tensor_parallel()
    if ctx is None or cfg.family not in FAMILIES:
        return None
    from ..launch.mesh import axis_names, axis_size
    mesh, axis = ctx
    if axis not in axis_names(mesh) or axis_size(mesh, axis) == 1:
        return None
    return ModelAxis(mesh.get_group(axis), axis_size(mesh, axis),
                     mesh.get_local_rank(axis))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------
# the conjugate pair, and the gathers
# --------------------------------------------------------------------------

class _CopyIn(torch.autograd.Function):
    """Forward: ``x``.  Backward: the sum of the gradient over the
    group (each rank's product used its own columns of the weight)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from ..dist.comm import all_reduce
        SENT["reduce"] += _nbytes(g)
        return all_reduce(g, "sum", ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Forward: the sum of ``x`` over each group in turn, times
    ``scale``.  Backward: the incoming gradient, unchanged.

    Every rank of the groups then uses the result alike: the sum of a
    row-parallel product's partial outputs over 'model' (its input
    gradient is the output's), and the MoE aux loss meaned over the
    batch axes, whose per-rank gradients the training step averages over
    the batch axes afterwards."""

    @staticmethod
    def forward(ctx, x, groups, scale):
        from ..dist.comm import all_reduce
        for g in groups:
            SENT["reduce"] += _nbytes(x)
            x = all_reduce(x, "sum", g)
        return x * scale if scale != 1 else x

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """Forward: the ranks' slices of dim ``dim`` concatenated in rank
    order.  Backward: the rank's slice of the gradient, summed over the
    ranks first when each used its own part of the whole (``summed``),
    taken as it is when every rank computed the same gradient."""

    @staticmethod
    def forward(ctx, w, dim, ax, summed):
        from ..dist.comm import all_gather
        ctx.dim, ctx.ax, ctx.summed, ctx.n = dim, ax, summed, w.shape[dim]
        SENT["gather"] += _nbytes(w)
        out = all_gather(w.movedim(dim, 0).contiguous(), ax.group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        from ..dist.comm import reduce_scatter
        ax = ctx.ax
        if ctx.summed:
            SENT["gather"] += _nbytes(g)
            g = reduce_scatter(g.movedim(ctx.dim, 0).contiguous(),
                               ax.group).movedim(0, ctx.dim)
        else:
            g = g.narrow(ctx.dim, ax.rank * ctx.n, ctx.n)
        return g, None, None, None


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` forward, its gradient summed over ``group`` backward."""
    if dist.get_world_size(group) == 1:
        return x
    return _CopyIn.apply(x, group)


def reduce_out(x: torch.Tensor, groups: Sequence, scale: float = 1.0
               ) -> torch.Tensor:
    """g: the sum of ``x`` over each of ``groups`` (times ``scale``)
    forward, the gradient unchanged backward."""
    return _ReduceOut.apply(x, list(groups), scale)


def gather(w: torch.Tensor, dim: int, ax: ModelAxis,
           summed: bool) -> torch.Tensor:
    """``w``'s slices of ``dim`` gathered over the model axis
    (:class:`_Gather`)."""
    return _Gather.apply(w, dim % w.dim(), ax, summed)


def take(w: torch.Tensor, dim: int, whole: int, lo: int, hi: int,
         ax: ModelAxis) -> torch.Tensor:
    """``[lo, hi)`` of dim ``dim`` of a weight whose whole size there is
    ``whole``: the rank's own slice as it is, a gathered one narrowed
    (its gradient summed over the ranks), or a whole one narrowed (the
    gradient summed by :func:`copy_in`: every rank holds it whole and
    uses its own part)."""
    n = w.shape[dim]
    if n == whole:
        return copy_in(w, ax.group).narrow(dim, lo, hi - lo)
    if n * ax.size != whole:
        raise ValueError(f"a dim of {n} is neither whole ({whole}) nor "
                         f"a 1 / {ax.size} slice of it")
    if (lo, hi) == (ax.rank * n, (ax.rank + 1) * n):
        return w
    return gather(w, dim, ax, summed=True).narrow(dim, lo, hi - lo)


def whole(w: torch.Tensor, dim: int, n: int,
          ax: Optional[ModelAxis]) -> torch.Tensor:
    """A weight whole along ``dim`` (size ``n``) for a computation every
    model rank repeats: a slice is gathered, its gradient the rank's
    slice of the (equal) whole gradient."""
    if ax is None or w.shape[dim] == n:
        return w
    return gather(w, dim, ax, summed=False)


# --------------------------------------------------------------------------
# the split of each layer
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Heads:
    """The rank's q heads ``[h0, h1)`` and the KV heads ``[kv0, kv1)``
    they read; local q head ``i`` reads local KV head ``i // q_per_kv``
    (the flash kernel's GQA map)."""

    h0: int
    h1: int
    kv0: int
    kv1: int
    q_per_kv: int


def attn_heads(cfg, ax: Optional[ModelAxis]) -> Optional[Heads]:
    """The rank's heads where attention splits, else None (attention
    whole).  It splits where ``M | H`` and the rank's q heads read their
    KV heads as ``i // q_per_kv``: ``M | KV`` (the rank's own KV heads),
    or every rank's q heads lie within one KV head."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if ax is None or H % ax.size:
        return None
    h0, h1 = ax.slice_of(H)
    qpk = H // KV
    if KV % ax.size == 0:
        return Heads(h0, h1, h0 // qpk, h1 // qpk, qpk)
    if qpk % (h1 - h0) == 0:
        return Heads(h0, h1, h0 // qpk, h0 // qpk + 1, h1 - h0)
    return None


def attn_weights(cfg, p: dict, ax: Optional[ModelAxis],
                 heads: Optional[Heads], all_kv: bool = False) -> dict:
    """The attention weights a rank computes with: its heads' columns of
    ``wq`` / ``wk`` / ``wv`` (and biases) and rows of ``wo`` under
    ``heads``, every one whole without; with ``all_kv`` the columns of
    every KV head (a cache that holds them all)."""
    if ax is None:
        return p
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cols = {"q": (H * Dh, None), "k": (KV * Dh, None), "v": (KV * Dh, None)}
    if heads is not None:
        kv = None if all_kv else (heads.kv0 * Dh, heads.kv1 * Dh)
        cols = {"q": (H * Dh, (heads.h0 * Dh, heads.h1 * Dh)),
                "k": (KV * Dh, kv), "v": (KV * Dh, kv)}
    out = {}
    for name, w in p.items():
        key = "q" if name in ("wq", "bq", "wo") else name[1]
        n, span = cols[key]
        dim = -2 if name == "wo" else -1
        out[name] = (whole(w, dim, n, ax) if span is None
                     else take(w, dim, n, *span, ax))
    return out


def mlp_split(cfg, p: dict, ax: Optional[ModelAxis]):
    """(the MLP's weights a rank computes with, whether they are its
    slice of ``d_ff``)."""
    ff = cfg.d_ff
    if ax is None:
        return p, False
    if ff % ax.size:
        return {k: whole(w, -2 if k == "w_down" else -1, ff, ax)
                for k, w in p.items()}, False
    lo, hi = ax.slice_of(ff)
    return {k: take(w, -2 if k == "w_down" else -1, ff, lo, hi, ax)
            for k, w in p.items()}, True


def cache_kv_heads(cfg) -> int:
    """The KV heads a rank's decode cache holds: those its q heads read
    where attention splits, else all."""
    heads = attn_heads(cfg, active(cfg))
    return cfg.num_kv_heads if heads is None else heads.kv1 - heads.kv0


def rwkv_heads(cfg, ax: Optional[ModelAxis]) -> Optional[Tuple[int, int]]:
    """The rank's rwkv6 heads ``[h0, h1)`` where the time mix splits
    (``M | H``), else None (whole)."""
    if ax is None or cfg.num_heads % ax.size:
        return None
    return ax.slice_of(cfg.num_heads)


def cache_rwkv_heads(cfg) -> int:
    """The heads of a rank's ``wkv`` state: its own where the time mix
    splits, else all."""
    span = rwkv_heads(cfg, active(cfg))
    return cfg.num_heads if span is None else span[1] - span[0]


# --------------------------------------------------------------------------
# a sequence-sharded cache
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A rank's shard of a cache's sequence dim, split over the mesh dims
    whose process groups are ``groups`` (outer first): ``size`` shards,
    this rank's the ``rank``-th (major-to-minor, as ``PartitionSpec``
    lays a dim over several axes)."""

    groups: tuple
    size: int
    rank: int

    def span(self, n: int) -> Tuple[int, int]:
        """The whole cache's ``[lo, lo + n)`` of a shard of ``n``
        positions."""
        return self.rank * n, (self.rank + 1) * n

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ("max" / "sum") of ``t`` over the shards: over each
        group in turn."""
        from ..dist.comm import all_reduce
        for g in self.groups:
            SENT["combine"] += _nbytes(t)
            t = all_reduce(t, op, g)
        return t


def gather_heads(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """Every rank's heads (dim 1) of ``x``, in rank order: the q of a
    decode step whose heads are split over the model axis, for a split
    attention over a sequence-sharded cache (no grad)."""
    from ..dist.comm import all_gather
    SENT["combine"] += _nbytes(x)
    return all_gather(x.movedim(1, 0).contiguous(), ax.group).movedim(0, 1)


def vocab_split(cfg, ax: Optional[ModelAxis]) -> Optional[Tuple[int, int]]:
    """The rank's vocab range where the embedding and head split, else
    None."""
    if ax is None or cfg.vocab_size % ax.size:
        return None
    return ax.slice_of(cfg.vocab_size)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, lo: int,
                 dtype, ax: ModelAxis) -> torch.Tensor:
    """Vocab-parallel lookup in ``table``, the rows of vocab ids
    ``[lo, lo + len(table))``: those rows for the tokens in that range,
    zeros for the others, in ``dtype``, summed over the model axis."""
    n = table.shape[0]
    local = tokens.to(torch.int64) - lo
    mine = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    x = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_out(x, [ax.group])


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                      ax: ModelAxis):
    """(logsumexp over the whole vocab, the target logit) of the rank's
    vocab slice ``logits`` [..., V / M] of float32 logits starting at
    vocab id ``lo``: the max by an ``all_reduce(MAX)`` (held constant
    under grad, as a stabiliser), the sum of ``exp`` and the target,
    which only its owner holds, by :func:`reduce_out`."""
    from ..dist.comm import all_reduce
    m = logits.detach().amax(dim=-1)
    SENT["max"] += _nbytes(m)
    m = all_reduce(m, "max", ax.group)
    se = reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1),
                    [ax.group])
    n = logits.shape[-1]
    local = labels.to(torch.int64) - lo
    mine = (local >= 0) & (local < n)
    t = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    tgt = reduce_out(torch.where(mine, t, torch.zeros_like(t)), [ax.group])
    return m + torch.log(se), tgt


# --------------------------------------------------------------------------
# the local view of a placed tree
# --------------------------------------------------------------------------

def keeps_model_slice(cfg, path: str) -> bool:
    """Whether a step keeps the param at ``path`` (keystr form) local on
    the model axis: the embedding, the head, and the leaves whose compute
    splits in its family (``_KEEPS``: the attention and MLP leaves, the
    rwkv projections stored split over 'model'); the rest is gathered
    whole."""
    rule = _KEEPS.get(cfg.family)
    if rule is None:
        return False
    return path in ("['embed']", "['head']") or bool(re.search(rule, path))


def grad_placement(cfg, path: str, placement):
    """How a step's local gradient of the leaf at ``path`` lies on the
    model axis, where the param is placed as ``placement``: the param's
    own slice where :func:`keeps_model_slice` says so; a part of the
    whole (``Partial``) for the experts of the explicit-collective MoE
    variants (``set_shardmap_moe``), which slice whole weights
    themselves; else the same whole gradient on every model rank."""
    from torch.distributed.tensor import Partial, Replicate
    if keeps_model_slice(cfg, path):
        return placement
    if get_shardmap_moe() is not None and _EXPERT.search(path):
        return Partial()
    return Replicate()


def local_params(cfg, params, axis: str = MODEL_AXIS):
    """Every ``DTensor`` leaf of ``params`` gathered over each mesh dim
    but ``axis``, whose slice it keeps where :func:`keeps_model_slice`
    says so (the others are gathered whole): plain local tensors
    (``launch.sharding.gather_leaf``)."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import gather_leaf, keyed_leaves
    from ..train.tree import unflatten

    leaves, structure = keyed_leaves(params)
    return unflatten(structure, [
        gather_leaf(t, keep=lambda name, pl: name == axis)
        if isinstance(t, DTensor) and keeps_model_slice(cfg, path)
        else gather_leaf(t) if isinstance(t, DTensor) else t
        for path, t in leaves])
