"""Plain PyTorch oracles for the pairwise-distance and attention kernels.

The semantic ground truth in the ``aa + bb - 2ab`` form, float32, the
same form as the oracle of the JAX package (``repro.kernels.ref``), so
the two packages' oracles can be compared directly; ``mha`` is the
reference's multi-head attention oracle.  These materialize the whole
``[.., M, N]`` distance (or logit) tensor and are meant for tests and
small inputs; the wrappers in ``ops.py`` never call them.
``masked_logits`` is shared: ``mha`` and the plain flash-attention
version in ``ops.py`` both mask with it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, d] x [N, d] -> [M, N] squared Euclidean distances."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = (a * a).sum(dim=1)[:, None]
    bb = (b * b).sum(dim=1)[None, :]
    d2 = aa + bb - 2.0 * (a @ b.T)
    return torch.clamp_min(d2, 0.0)


def _eps2(eps, like: torch.Tensor) -> torch.Tensor:
    e = torch.as_tensor(eps, dtype=torch.float32, device=like.device)
    return e * e


def eps_count(a: torch.Tensor, b: torch.Tensor, eps,
              valid_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row count of points of ``b`` within ``eps`` of each row of ``a``."""
    hit = sq_dists(a, b) <= _eps2(eps, a)
    if valid_b is not None:
        hit = hit & valid_b[None, :]
    return hit.sum(dim=1).to(torch.int32)


def _masked_min_argmin(d2: torch.Tensor, valid: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min, first argmin) over the last axis after folding the validity
    mask (broadcast against ``d2``) to +inf; (inf, -1) where nothing is
    valid."""
    if valid is not None:
        d2 = torch.where(valid, d2, torch.inf)
    mins = d2.min(dim=-1).values
    idx = d2.argmin(dim=-1).to(torch.int32)
    idx = torch.where(torch.isinf(mins), torch.full_like(idx, -1), idx)
    return mins, idx


def row_min(a: torch.Tensor, b: torch.Tensor,
            valid_b: Optional[torch.Tensor] = None):
    """Per-row (min squared distance, argmin index) into ``b``.

    A fully-masked row (no valid b-point at all) reports ``(inf, -1)``,
    never an in-range index into masked rows."""
    return _masked_min_argmin(
        sq_dists(a, b), None if valid_b is None else valid_b[None, :])


def sq_dists_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, M, d] x [B, N, d] -> [B, M, N] squared Euclidean distances."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    aa = (a * a).sum(dim=-1)[:, :, None]
    bb = (b * b).sum(dim=-1)[:, None, :]
    ab = torch.einsum("bmd,bnd->bmn", a, b)
    return torch.clamp_min(aa + bb - 2.0 * ab, 0.0)


def eps_count_batch(a: torch.Tensor, b: torch.Tensor, eps,
                    valid_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-batch per-row eps-counts: a [B, M, d], b [B, N, d], valid_b
    [B, N] -> [B, M] int32."""
    hit = sq_dists_batch(a, b) <= _eps2(eps, a)
    if valid_b is not None:
        hit = hit & valid_b[:, None, :]
    return hit.sum(dim=-1).to(torch.int32)


def row_min_batch(a: torch.Tensor, b: torch.Tensor,
                  valid_b: Optional[torch.Tensor] = None):
    """Batched :func:`row_min`: a [B, M, d], b [B, N, d], valid_b [B, N]
    -> ([B, M] f32 min d2, [B, M] int32 argmin; (inf, -1) for rows with
    no valid b-point)."""
    return _masked_min_argmin(
        sq_dists_batch(a, b),
        None if valid_b is None else valid_b[:, None, :])


def eps_count_band_batch(a: torch.Tensor, b: torch.Tensor, eps_lo, eps_hi,
                         valid_b: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-threshold batched eps-counts: hits at ``d2 <= eps_lo**2`` and
    at ``d2 <= eps_hi**2`` (a [B, M, d], b [B, N, d] -> two [B, M]
    int32), the bracket the guard band proves core decisions with."""
    d2 = sq_dists_batch(a, b)
    hit_lo = d2 <= _eps2(eps_lo, a)
    hit_hi = d2 <= _eps2(eps_hi, a)
    if valid_b is not None:
        hit_lo = hit_lo & valid_b[:, None, :]
        hit_hi = hit_hi & valid_b[:, None, :]
    return (hit_lo.sum(dim=-1).to(torch.int32),
            hit_hi.sum(dim=-1).to(torch.int32))


def row_min2_batch(a: torch.Tensor, b: torch.Tensor,
                   valid_b: Optional[torch.Tensor] = None):
    """Batched (min, runner-up, argmin) squared distances: a [B, M, d],
    b [B, N, d], valid_b [B, N] -> ([B, M] f32 min, [B, M] f32
    second-smallest over the remaining slots, [B, M] int32 argmin).  No
    valid candidate -> (inf, inf, -1); exactly one -> (d2, inf, idx)."""
    d2 = sq_dists_batch(a, b)
    if valid_b is not None:
        d2 = torch.where(valid_b[:, None, :], d2, torch.inf)
    mins, idx = _masked_min_argmin(d2, None)
    cols = torch.arange(d2.shape[-1], device=d2.device)
    first = d2.argmin(dim=-1)
    d2_wo = torch.where(cols[None, None, :] == first[:, :, None],
                        torch.inf, d2)
    return mins, d2_wo.min(dim=-1).values, idx


def min_dist(a: torch.Tensor, va: torch.Tensor,
             b: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Minimum squared distance between two masked sets (0-d float32;
    inf when no valid pair exists)."""
    d2 = torch.where(va[:, None] & vb[None, :], sq_dists(a, b), torch.inf)
    return d2.min()


def masked_logits(q: torch.Tensor, k: torch.Tensor, *, q_offset: int,
                  causal: bool, window: Optional[int],
                  softcap: Optional[float], scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention kernels' logits: q [.., n, D] against k [.., Sk, D]
    in float32, scaled, then soft-capped (``tanh(x/cap)·cap``), then
    masked to the finite ``NEG_INF`` where query row i (at key position
    ``i + q_offset``) may not see a key: ``kpos > qpos`` when causal,
    ``qpos - kpos >= window`` under a sliding window.  Returns (logits,
    the [n, Sk] mask of live pairs)."""
    n, Sk = q.shape[-2], k.shape[-2]
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) \
        * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(n, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return torch.where(mask, logits, NEG_INF), mask


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: Optional[int] = None,
        softcap: Optional[float] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Reference multi-head attention.

    q: [B, H, Sq, D], k/v: [B, H, Sk, D] (kv heads already broadcast).
    ``window``: sliding-window width (keys with q_pos - k_pos >= window
    masked out); ``softcap``: gemma2-style tanh logit soft capping.
    Query position i is aligned to key position i + (Sk - Sq) so decode
    (Sq=1) attends to the full prefix.  Logits and softmax in float32,
    the probabilities cast to v's dtype before the product with v.
    """
    Sq, D = q.shape[2], q.shape[3]
    logits, _ = masked_logits(
        q, k, q_offset=k.shape[2] - Sq, causal=causal, window=window,
        softcap=softcap, scale=D ** -0.5 if scale is None else scale)
    p = torch.softmax(logits, dim=-1)
    return p.to(v.dtype) @ v
