"""FastMerging (paper §4.3, Algorithms 4-5).

Decides exactly whether ``MinDist(s_i, s_j) <= eps`` while pruning
distance work via two spatial strategies:

* triangle-inequality pruning: with pivot ``p`` and its nearest point
  ``q`` in the other set at distance > eps, every ``x`` with
  ``dist(x, p) < dist(p, q) - eps`` can never reach the other set.
* angle pruning (Theorem 1): every ``x`` whose angle to ``pq`` exceeds
  ``lambda = max_y [ arcsin(eps / dist(p, y)) + angle(pq, py) ]``
  is provably outside every ``N_eps(y)``;  Theorem 1 guarantees
  ``lambda < 5*pi/6`` for neighboring core grids, so the pruned region
  is never empty and the loop always progresses.

Three engines, identical decisions:

* ``fast_merging``        -- host, paper-faithful (physical point removal).
* ``fast_merging_batch``  -- torch, removal -> mask update, fixed shapes,
                             one loop over the paper's kappa iterations
                             for a whole batch of grid pairs.
* ``center_prune_merge``  -- the KNN-BLOCK-DBSCAN-style baseline the paper
                             compares against in §4.3.1 (single
                             center-distance filter, then brute force).

All report the number of iterations (paper's kappa) so the paper's
efficiency story can be reproduced.
"""

from __future__ import annotations

import numpy as np
import torch

from .sync import count_read

_INF = np.float64(np.inf)


# --------------------------------------------------------------------------
# host, paper-faithful
# --------------------------------------------------------------------------

def _prune(si: np.ndarray, sj: np.ndarray, p: np.ndarray, q: np.ndarray,
           eps: float) -> np.ndarray:
    """Algorithm 4: remove trivial points from ``si`` (returns kept rows)."""
    dpq = np.linalg.norm(p - q)
    sigma = dpq - eps
    # lambda = max_y arcsin(eps/d(p,y)) + angle(pq, py)   (eq. 5, eq. 10)
    py = sj - p[None, :]
    dpy = np.linalg.norm(py, axis=1)
    # all y satisfy d(p,y) >= d(p,q) > eps  (q is the argmin), so arcsin is safe
    cos_t1 = np.clip((py @ (q - p)) / (dpy * dpq), -1.0, 1.0)
    lam = float(np.max(np.arcsin(np.clip(eps / dpy, -1.0, 1.0)) + np.arccos(cos_t1)))

    px = si - p[None, :]
    dpx = np.linalg.norm(px, axis=1)
    tri = dpx < sigma                                   # triangle-inequality prune
    with np.errstate(invalid="ignore", divide="ignore"):
        cos_g = np.clip((px @ (q - p)) / (dpx * dpq), -1.0, 1.0)
        theta = np.arccos(cos_g)
    theta = np.where(dpx == 0.0, 0.0, theta)            # x == p handled by tri
    ang = theta > lam                                   # angle prune
    return si[~(tri | ang)]


def fast_merging(si: np.ndarray, sj: np.ndarray, eps: float,
                 rng: np.random.Generator | None = None,
                 stats: dict | None = None) -> bool:
    """Algorithm 5 (host). Exact: True iff MinDist(si, sj) <= eps."""
    si = np.asarray(si, np.float64).copy()
    sj = np.asarray(sj, np.float64).copy()
    if si.size == 0 or sj.size == 0:
        return False
    eps = float(eps)
    idx = 0 if rng is None else int(rng.integers(len(si)))
    p = si[idx]
    iters = 0
    dist_evals = 0
    while True:
        iters += 1
        # q = argmin_{y in s_j} dist(p, y)
        dj = np.linalg.norm(sj - p[None, :], axis=1)
        dist_evals += len(sj)
        jq = int(np.argmin(dj))
        q = sj[jq]
        if dj[jq] <= eps:
            break_yes = True
            break
        si = _prune(si, sj, p, q, eps)
        dist_evals += len(si)
        if len(si) == 0:
            break_yes = False
            break
        # p = argmin_{x in s_i} dist(x, q)
        di = np.linalg.norm(si - q[None, :], axis=1)
        dist_evals += len(si)
        ip = int(np.argmin(di))
        p = si[ip]
        if di[ip] <= eps:
            break_yes = True
            break
        sj = _prune(sj, si, q, p, eps)
        dist_evals += len(sj)
        if len(sj) == 0:
            break_yes = False
            break
    if stats is not None:
        stats["iters"] = stats.get("iters", 0) + iters
        stats["max_iters"] = max(stats.get("max_iters", 0), iters)
        stats["dist_evals"] = stats.get("dist_evals", 0) + dist_evals
        stats["calls"] = stats.get("calls", 0) + 1
    return break_yes


def brute_min_dist(si: np.ndarray, sj: np.ndarray) -> float:
    """O(m_i * m_j) oracle for MinDist (paper §4.3.1 'straightforward way')."""
    d2 = ((si[:, None, :] - sj[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min()))


def center_prune_merge(si: np.ndarray, sj: np.ndarray, eps: float,
                       stats: dict | None = None) -> bool:
    """KNN-BLOCK-DBSCAN-style merging baseline (paper §4.3.1).

    Prunes p in s_i with dist(p, c_j) > eps + xi_j (and symmetrically),
    then brute-forces the rest.  Exact, but degrades to O(m_i m_j).
    """
    si = np.asarray(si, np.float64)
    sj = np.asarray(sj, np.float64)
    ci, cj = si.mean(0), sj.mean(0)
    xi_i = np.linalg.norm(si - ci[None], axis=1).max()
    xi_j = np.linalg.norm(sj - cj[None], axis=1).max()
    keep_i = np.linalg.norm(si - cj[None], axis=1) <= eps + xi_j
    keep_j = np.linalg.norm(sj - ci[None], axis=1) <= eps + xi_i
    a, b = si[keep_i], sj[keep_j]
    if stats is not None:
        stats["dist_evals"] = stats.get("dist_evals", 0) + \
            len(si) + len(sj) + len(a) * len(b)
        stats["calls"] = stats.get("calls", 0) + 1
    if len(a) == 0 or len(b) == 0:
        return False
    return brute_min_dist(a, b) <= eps


# --------------------------------------------------------------------------
# device, masked (removal -> mask update), fixed shapes, batched over pairs
# --------------------------------------------------------------------------

def _sum_feat(x: torch.Tensor) -> torch.Tensor:
    """Sum over the (short) feature axis, terms added in index order."""
    out = x[..., 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k]
    return out


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_sum_feat(x * x))


def _masked_prune(A, va, B, vb, p, q, eps):
    """Algorithm 4 on masks, batched: A [N, Ma, d], B [N, Mb, d], pivots
    p, q [N, d]; returns the updated validity mask for A.

    The angular test runs entirely in cosine space: with
    ``lam_y = arcsin(eps/d(p,y)) + arccos(cos_b)`` and
    ``theta_x = arccos(cos_g)`` all in [0, pi] where cosine is strictly
    decreasing, ``theta_x > max_y lam_y`` is equivalent to
    ``cos_g < min_y cos(lam_y)`` with
    ``cos(a + b) = cos_a cos_b - sin_a sin_b`` (sum identity), unless
    some ``lam_y`` exceeds pi -- detected as ``cos_b < -cos_a`` (since
    ``a <= pi/2``), in which case ``lam >= pi >= theta`` and no point
    is angle-pruned."""
    pq = (q - p)[:, None, :]
    dpq = _norm(p - q)                                     # [N]
    safe_dpq = torch.clamp_min(dpq, 1e-30)[:, None]
    sigma = (dpq - eps)[:, None]
    py = B - p[:, None, :]
    dpy = _norm(py)
    safe_dpy = torch.clamp_min(dpy, 1e-30)
    cos_b = torch.clamp(_sum_feat(py * pq) / (safe_dpy * safe_dpq), -1., 1.)
    sin_a = torch.clamp(eps / safe_dpy, 0., 1.)
    cos_a = torch.sqrt(1. - sin_a * sin_a)
    sin_b = torch.sqrt(1. - cos_b * cos_b)
    cos_ab = cos_a * cos_b - sin_a * sin_b
    over_pi = (vb & (cos_b < -cos_a)).any(dim=1)
    # empty B: min over nothing -> +inf, so every x is angle-pruned
    # (matching the lam = -inf behavior of the angle-space form)
    cos_lam = torch.where(vb, cos_ab, torch.inf).min(dim=1).values

    px = A - p[:, None, :]
    dpx = _norm(px)
    tri = dpx < sigma
    cos_g = torch.clamp(_sum_feat(px * pq)
                        / (torch.clamp_min(dpx, 1e-30) * safe_dpq), -1., 1.)
    cos_g = torch.where(dpx == 0.0, torch.ones_like(cos_g), cos_g)  # theta(p) = 0
    ang = (cos_g < cos_lam[:, None]) & ~over_pi[:, None]
    return va & ~(tri | ang)


def _masked_argmin(dists, valid):
    d = torch.where(valid, dists, torch.inf)
    i = torch.argmin(d, dim=1)                     # first occurrence
    return i, torch.gather(d, 1, i[:, None])[:, 0]


def fast_merging_batch(si: torch.Tensor, valid_i: torch.Tensor,
                       sj: torch.Tensor, valid_j: torch.Tensor,
                       eps, max_iters: int = 64):
    """Algorithm 5 with masking for a batch of grid pairs.

    Args:
      si: [N, Mi, d] padded point sets, valid_i: [N, Mi] bool.
      sj: [N, Mj, d] padded point sets, valid_j: [N, Mj] bool.
    Returns:
      (merge [N] bool, iters [N] int32) -- ``iters`` is the paper's
      kappa per pair.

    One loop serves the whole batch: each round gathers the pairs that
    are still live (not decided, both sets non-empty, below
    ``max_iters``), advances exactly those by one iteration and writes
    their state back, so a pair's state and its ``iters`` move only
    while its own loop condition holds.  Each round costs one host read
    (the list of live pairs)."""
    dev = si.device
    si = si.to(torch.float32)
    sj = sj.to(torch.float32)
    eps = torch.as_tensor(eps, dtype=torch.float32, device=dev)
    N = si.shape[0]

    va = valid_i.clone()
    vb = valid_j.clone()
    # pivot: first valid point of s_i
    p_idx = torch.argmax(valid_i.to(torch.uint8), dim=1)
    done = ~(valid_i.any(dim=1) & valid_j.any(dim=1))
    res = torch.zeros((N,), dtype=torch.bool, device=dev)
    it = torch.zeros((N,), dtype=torch.int32, device=dev)

    for _ in range(max_iters):
        live = ~done & va.any(dim=1) & vb.any(dim=1) & (it < max_iters)
        idx = torch.nonzero(live)[:, 0]
        count_read()
        if idx.numel() == 0:
            break
        A, B, a_ok, b_ok = si[idx], sj[idx], va[idx], vb[idx]
        rows = torch.arange(idx.numel(), device=dev)

        p = A[rows, p_idx[idx]]
        jq, dq = _masked_argmin(_norm(B - p[:, None, :]), b_ok)
        q = B[rows, jq]
        hit1 = dq <= eps
        a_ok2 = torch.where(hit1[:, None], a_ok,
                            _masked_prune(A, a_ok, B, b_ok, p, q, eps))
        empty_i = ~a_ok2.any(dim=1)
        ip, dp = _masked_argmin(_norm(A - q[:, None, :]), a_ok2)
        hit2 = ~hit1 & ~empty_i & (dp <= eps)
        p2 = A[rows, ip]
        b_ok2 = torch.where((hit1 | hit2 | empty_i)[:, None], b_ok,
                            _masked_prune(B, b_ok, A, a_ok2, q, p2, eps))

        va[idx], vb[idx], p_idx[idx] = a_ok2, b_ok2, ip
        done[idx] = hit1 | hit2 | empty_i | ~b_ok2.any(dim=1)
        res[idx] = res[idx] | hit1 | hit2
        it[idx] = it[idx] + 1
    return res, it
