"""Brute DBSCAN in float64 on a device, and the judgments of the
program's answers against it.

The sweeps are a frozen copy of ``check_conformant_brute`` in
``src/repro_torch/core/validate.py`` at commit
2a510f07d994490e1c1c2f354f6b6064be47a8b3, split into what it computes
(:func:`dbscan`) and what it checks (:func:`judge_fit`), so one
reference serves every fit of a window.  On integer coordinates below
``EXACT_INT`` the squared distance is one float64 matrix product,
``[a, |a|², 1] · [−2b, 1, |b|²]``: every product and partial sum is then
an integer below 2^53, so it equals ``Σ_k (a_k − b_k)²`` exactly, in any
order, with a fraction of the memory traffic of the sum of differences
(the paper's eps puts some 10^11 pairs in a sweep of 10^6 points):

1. neighbour counts including self (``Σ_k (a_k − b_k)² <= eps²``, summed
   in k order); a point is core iff its count >= ``min_pts``.  Points
   are sorted by their first coordinate and each chunk of consecutive
   queries scans only the contiguous window within ``eps`` of it on that
   coordinate; chunk x window blocks hold at most ``budget_bytes`` of
   temporaries (``PAIR_BYTES`` a pair);
2. the core–core pairs within eps (``j > i`` in key order);
3. the components of that graph: min-label hooking and pointer jumping,
   each round a sweep over the pairs' blocks (the frozen copy stores the
   pairs; a dense set has 10^10 and more of them);
4. per non-core point, whether a core lies within eps and the least and
   greatest component among those cores (contested when they differ),
   and for the contested points the whole set of components.

``precision="float32-gemm"`` computes every distance in float32 as a
matrix product computes it, ``|a|² + |b|² − 2 a·b`` over absolute
coordinates (TF32 off): the benchmark's control.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict

import numpy as np
import torch

#: bytes of temporaries one (query, candidate) pair of a block takes: the
#: float64 sum and one float64 term, the mask and its reductions
PAIR_BYTES = 24
#: the label a component maps to when no program label can stand for it
UNMAPPED = -5
#: integer coordinates up to this magnitude (d <= 8) keep every term of the
#: matrix-product form of a squared distance an integer below 2^53
EXACT_INT = 2 ** 20


def _say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _plan(lo: np.ndarray, hi: np.ndarray, budget: int) -> list:
    """Blocks ``(s, e, c0, c1)`` of at most ``budget`` pairs: rows ``s ..
    e - 1`` (consecutive in key order, ``lo`` / ``hi`` nondecreasing)
    against the columns ``c0 .. c1 - 1`` of their joint window; a window
    wider than the budget allows for one row is split over blocks."""
    blocks, n, s = [], len(lo), 0
    while s < n:
        a, b = s + 1, n
        while a < b:                     # the most rows within the budget
            m = (a + b + 1) // 2
            if (m - s) * max(int(hi[m - 1]) - int(lo[s]), 0) <= budget:
                a = m
            else:
                b = m - 1
        c0, c1 = int(lo[s]), int(hi[a - 1])
        step = max(1, budget // (a - s))
        blocks += [(s, a, c, min(c + step, c1)) for c in range(c0, c1, step)]
        s = a
    return blocks


def exact_int(pts: np.ndarray) -> bool:
    """Whether ``pts`` are integers small enough for the exact product."""
    return (pts.shape[1] <= 8 and bool(np.all(pts == np.rint(pts)))
            and float(np.abs(pts).max(initial=0.0)) <= EXACT_INT)


def sq_dist(q: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    """[m, d] x [k, d] -> [m, k] squared distances.  ``float64``: the
    terms summed in k order on float64 operands; ``float64-int``: the same
    numbers on integer coordinates (:func:`exact_int`) as one float64
    matrix product; ``float32-gemm``: the matrix-product expansion in
    float32 (returned as float64)."""
    if precision == "float64-int":
        one_q, one_c = q.new_ones(q.shape[0], 1), c.new_ones(c.shape[0], 1)
        qa = torch.cat([q, (q * q).sum(1, keepdim=True), one_q], 1)
        ca = torch.cat([-2.0 * c, one_c, (c * c).sum(1, keepdim=True)], 1)
        return qa @ ca.T
    if precision == "float64":
        d2 = None
        for k in range(q.shape[1]):
            t = q[:, None, k] - c[None, :, k]
            t.mul_(t)
            d2 = t if d2 is None else d2.add_(t)
        return d2
    if precision != "float32-gemm":
        raise ValueError(f"unknown precision {precision!r}")
    q32, c32 = q.to(torch.float32), c.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d2 = ((q32 * q32).sum(1)[:, None] + (c32 * c32).sum(1)[None, :]
              - 2.0 * (q32 @ c32.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return d2.to(torch.float64)


def _within(q, c, eps2, precision):
    return sq_dist(q, c, precision) <= eps2


def _windows(qkey, ckey, r):
    return (torch.searchsorted(ckey, qkey - r, side="left"),
            torch.searchsorted(ckey, qkey + r, side="right"))


@dataclasses.dataclass
class Reference:
    """Brute DBSCAN of one point set, in the set's own row order.

    ``comp[i]``: the component of a core point, the one component of an
    uncontested border point, -1 for noise, -2 for a contested point
    (its components are ``contested[i]``)."""

    core: np.ndarray
    comp: np.ndarray
    contested: Dict[int, np.ndarray]
    n_components: int
    core_pts: torch.Tensor          # float64 [nc, d], sorted by x
    core_comp: torch.Tensor         # int64 [nc]
    eps: float
    precision: str
    stats: dict


def dbscan(points, eps: float, min_pts: int, *, device,
           precision: str = "float64", budget_bytes: int = 2 << 30
           ) -> Reference:
    """Brute DBSCAN of ``points`` ([n, d], float64) on ``device``; with
    ``precision="float64"`` on integer coordinates the distances take the
    exact product (``float64-int``)."""
    dev = torch.device(device)
    t_start = time.perf_counter()
    pts_np = np.asarray(points, np.float64)
    if precision == "float64" and exact_int(pts_np):
        precision = "float64-int"
    n, d = pts_np.shape
    eps2 = float(eps) ** 2
    budget = max(1, int(budget_bytes) // PAIR_BYTES)
    pts = torch.as_tensor(pts_np, device=dev)
    order = torch.argsort(pts[:, 0], stable=True)
    sp = pts[order].contiguous()
    key = sp[:, 0].contiguous()
    # the window's half width: eps, widened past any rounding of x ± r
    r = float(eps) * (1.0 + 1e-9) + 1e-12 * float(np.abs(pts_np).max())
    lo, hi = _windows(key, key, r)

    # (1) neighbour counts, every point against its window
    plan = _plan(lo.cpu().numpy(), hi.cpu().numpy(), budget)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    for s, e, c0, c1 in plan:
        counts[s:e] += _within(sp[s:e], sp[c0:c1], eps2, precision).sum(1)
    core_s = counts >= min_pts
    pairs = sum((e - s) * (c1 - c0) for s, e, c0, c1 in plan)

    # (2) the core-core pairs within eps (j > i in key order)
    cpos = torch.nonzero(core_s)[:, 0]
    nc = int(cpos.numel())
    cp = sp[cpos].contiguous()
    ckey = cp[:, 0].contiguous()
    clo, chi = _windows(ckey, ckey, r)
    clo = torch.maximum(clo, torch.arange(1, nc + 1, device=dev))
    cplan = _plan(clo.cpu().numpy(), chi.cpu().numpy(), budget)

    def upper(s, e, c0, c1):
        w = _within(cp[s:e], cp[c0:c1], eps2, precision)
        return w & (torch.arange(c0, c1, device=dev)[None, :]
                    > torch.arange(s, e, device=dev)[:, None])

    # (3) components: min-label hooking + pointer jumping.  The pairs
    # are not stored (a dense varden set has 10^9 of them): each round
    # sweeps the core-core blocks again and hooks every pair at once,
    # aggregated per row and per column, from the round's starting labels
    comp = torch.arange(nc, device=dev)
    n_pairs = 0
    rounds = 0
    while nc:
        rounds += 1
        prev = comp.clone()
        for s, e, c0, c1 in cplan:
            w = upper(s, e, c0, c1)
            if rounds == 1:
                n_pairs += int(w.sum().item())
            fu, fv = prev[s:e], prev[c0:c1]
            rmin = torch.where(w, fv[None, :], nc).amin(1)
            cmin = torch.where(w, fu[:, None], nc).amin(0)
            comp.scatter_reduce_(0, fu, torch.minimum(fu, rmin), "amin")
            comp.scatter_reduce_(0, fv, torch.minimum(fv, cmin), "amin")
        while True:
            nxt = comp[comp]
            if torch.equal(nxt, comp):
                break
            comp = nxt
        if torch.equal(comp, prev):
            break
    # dense component ids 0 .. k-1
    _, comp = torch.unique(comp, return_inverse=True)
    n_comp = int(comp.max().item()) + 1 if nc else 0

    # (4) every non-core point against the cores of its window
    npos = torch.nonzero(~core_s)[:, 0]
    qp = sp[npos].contiguous()
    nlo, nhi = _windows(qp[:, 0].contiguous(), ckey, r)
    bplan = _plan(nlo.cpu().numpy(), nhi.cpu().numpy(), budget)
    nn = int(npos.numel())
    has = torch.zeros(nn, dtype=torch.bool, device=dev)
    big = torch.iinfo(torch.int64).max
    cmin = torch.full((nn,), big, dtype=torch.int64, device=dev)
    cmax = torch.full((nn,), -1, dtype=torch.int64, device=dev)
    for s, e, c0, c1 in bplan:
        w = _within(qp[s:e], cp[c0:c1], eps2, precision)
        has[s:e] |= w.any(1)
        cc = comp[c0:c1][None, :]
        cmin[s:e] = torch.minimum(cmin[s:e], torch.where(w, cc, big).amin(1))
        cmax[s:e] = torch.maximum(cmax[s:e], torch.where(w, cc, -1).amax(1))
    contested = has & (cmin != cmax)

    # the contested points' whole sets of components
    sets: Dict[int, np.ndarray] = {}
    kpos = torch.nonzero(contested)[:, 0]
    if kpos.numel():
        kq = qp[kpos].contiguous()
        klo, khi = nlo[kpos], nhi[kpos]
        kids = order[npos[kpos]].cpu().numpy()
        for j in range(int(kpos.numel())):
            a, b = int(klo[j]), int(khi[j])
            w = _within(kq[j:j + 1], cp[a:b], eps2, precision)[0]
            sets[int(kids[j])] = torch.unique(comp[a:b][w]).cpu().numpy()

    lab_s = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lab_s[cpos] = comp
    lab_s[npos] = torch.where(has, torch.where(contested, -2, cmin), -1)
    out_comp = torch.empty_like(lab_s)
    out_comp[order] = lab_s
    out_core = torch.empty_like(core_s)
    out_core[order] = core_s
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats = dict(n=n, d=d, cores=nc, clusters=n_comp,
                 border=int(has.sum().item()),
                 contested=int(contested.sum().item()),
                 noise=int((~has).sum().item()), count_pairs=pairs,
                 core_core_pairs=n_pairs, rounds=rounds,
                 seconds=time.perf_counter() - t_start)
    _say(f"reference ({precision}): n={n} d={d} {nc:,} cores, {n_comp:,} "
         f"clusters, {stats['contested']:,} contested, {stats['noise']:,} "
         f"noise, {n_pairs:,} core-core pairs, {stats['seconds']:.3f} s")
    return Reference(core=out_core.cpu().numpy(), comp=out_comp.cpu().numpy(),
                     contested=sets, n_components=n_comp, core_pts=cp,
                     core_comp=comp, eps=float(eps), precision=precision,
                     stats=stats)


def labels_of(ref: Reference) -> np.ndarray:
    """A DBSCAN labelling by the reference itself (a contested point
    takes its least component): what the control puts in the program's
    place."""
    lab = ref.comp.copy()
    for i, comps in ref.contested.items():
        lab[i] = comps.min()
    return lab


def label_map(ref: Reference, labels: np.ndarray) -> np.ndarray:
    """Each reference component's label in the program's labelling: the
    label most of its cores carry; a label that stands for several
    components keeps the one where it is most common, and a component
    left without a label, or whose cores are mostly noise, maps to
    ``UNMAPPED``."""
    out = np.full(max(ref.n_components, 1), UNMAPPED, np.int64)
    rc = ref.core
    if not rc.any():
        return out
    comps = ref.comp[rc].astype(np.int64)
    labs = np.asarray(labels, np.int64)[rc]
    base = int(labs.max(initial=-1)) + 2
    keys, counts = np.unique(comps * base + (labs + 1), return_counts=True)
    kc, kl = keys // base, keys % base - 1
    pick = np.lexsort((-counts, kc))
    first = np.ones(len(pick), bool)
    first[1:] = kc[pick][1:] != kc[pick][:-1]
    maj = pick[first]                      # one row per component
    mc, ml, mn = kc[maj], kl[maj], counts[maj]
    order = np.lexsort((-mn, ml))
    keep = np.ones(len(order), bool)
    keep[1:] = ml[order][1:] != ml[order][:-1]
    win = order[keep & (ml[order] >= 0)]
    out[mc[win]] = ml[win]
    return out


def judge_fit(ref: Reference, labels, core) -> dict:
    """Errors of one fit's labels and core flags (the set's row order):
    core flags that differ from the reference, and points whose label
    no DBSCAN labelling of these points can give (a core outside its
    cluster's label, a noise point in a cluster, a border point as noise
    or in a cluster without a core within eps)."""
    labels = np.asarray(labels, np.int64)
    core = np.asarray(core, bool)
    m = label_map(ref, labels)
    core_err = int((core != ref.core).sum())
    rc = ref.core
    bad = np.zeros(len(labels), bool)
    bad[rc] = labels[rc] != m[ref.comp[rc]]
    noise = ~rc & (ref.comp == -1)
    bad[noise] = labels[noise] != -1
    border = ~rc & (ref.comp >= 0)
    bad[border] = labels[border] != m[ref.comp[border]]
    for i, comps in ref.contested.items():
        bad[i] = not np.isin(labels[i], m[comps]) or labels[i] < 0
    return {"core_flag_errors": core_err, "label_errors": int(bad.sum()),
            "map": m}
