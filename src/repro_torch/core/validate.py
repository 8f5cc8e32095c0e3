"""Equivalence checking between DBSCAN labelings.

DBSCAN's clustering is unique on core points and noise; *border* points
may validly belong to any cluster owning a core point within eps (the
original paper and Alg. 6 both assign them order-dependently).  Two
labelings are therefore equivalent iff:

  1. identical core-point sets,
  2. identical partitions of the core points into clusters,
  3. identical noise sets (a non-core point is border iff it has a core
     point within eps -- regardless of which cluster claimed it),
  4. every border assignment is *valid*: its cluster contains a core
     point within eps of it.

:func:`check_conformant_brute` computes the brute DBSCAN of
``core/dbscan.py::brute_dbscan`` and checks a labelling against it as
:func:`assert_labels_conformant` does, in chunked float64 sweeps on a
device (the card by default), so that a fit of 10^6 points is checked
point for point.  It uses torch primitives only and nothing of the code
it checks (the grids, the grid tree, merging, the kernels, the index).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def contested_border_mask(points: np.ndarray, eps: float,
                          core: np.ndarray,
                          core_labels: np.ndarray) -> np.ndarray:
    """True for non-core points reachable from cores of >1 cluster.

    Those are the only points whose DBSCAN label is genuinely
    order-dependent; everywhere else the output is unique and two exact
    engines must agree label-for-label (after canonicalization).
    ``core_labels`` is any labeling of the core partition.
    """
    pts = np.asarray(points, np.float64)
    eps2 = float(eps) ** 2
    out = np.zeros(len(pts), bool)
    cpts = pts[core]
    clab = np.asarray(core_labels)[core]
    for i in np.flatnonzero(~core):
        d2 = ((cpts - pts[i]) ** 2).sum(1)
        cands = np.unique(clab[d2 <= eps2])
        out[i] = len(cands) > 1
    return out


def core_flags(points: np.ndarray, eps: float, min_pts: int,
               chunk: int = 2048) -> np.ndarray:
    pts = np.asarray(points, np.float64)
    n = len(pts)
    eps2 = float(eps) ** 2
    counts = np.zeros(n, dtype=np.int64)
    for s in range(0, n, chunk):
        d2 = ((pts[s:s + chunk, None, :] - pts[None, :, :]) ** 2).sum(-1)
        counts[s:s + chunk] = (d2 <= eps2).sum(1)
    return counts >= min_pts


def _partition_signature(labels: np.ndarray, mask: np.ndarray) -> set:
    sig = {}
    for i in np.flatnonzero(mask):
        sig.setdefault(labels[i], []).append(i)
    return {frozenset(v) for v in sig.values()}


def assert_dbscan_equivalent(points: np.ndarray, eps: float, min_pts: int,
                             labels_a: np.ndarray, labels_b: np.ndarray,
                             core: np.ndarray | None = None) -> None:
    pts = np.asarray(points, np.float64)
    eps2 = float(eps) ** 2
    if core is None:
        core = core_flags(pts, eps, min_pts)
    la, lb = np.asarray(labels_a), np.asarray(labels_b)

    # 1+2: core partition identical
    assert (la[core] >= 0).all(), "labeling A: core point marked noise"
    assert (lb[core] >= 0).all(), "labeling B: core point marked noise"
    pa = _partition_signature(la, core)
    pb = _partition_signature(lb, core)
    assert pa == pb, "core-point partitions differ"

    # 3: border/noise sets identical
    noncore = ~core
    for name, l in (("A", la), ("B", lb)):
        for i in np.flatnonzero(noncore):
            d2 = ((pts[core] - pts[i]) ** 2).sum(1)
            has_core = (d2 <= eps2).any()
            if has_core:
                assert l[i] >= 0, f"labeling {name}: border point {i} marked noise"
            else:
                assert l[i] < 0, f"labeling {name}: noise point {i} in a cluster"

    # 4: border assignments valid
    for name, l in (("A", la), ("B", lb)):
        for i in np.flatnonzero(noncore & (la >= 0 if name == "A" else lb >= 0)):
            same = core & (l == l[i])
            if not same.any():
                raise AssertionError(f"labeling {name}: border {i} in empty cluster")
            d2 = ((pts[same] - pts[i]) ** 2).sum(1)
            assert (d2 <= eps2).any(), \
                f"labeling {name}: border {i} assigned to cluster w/o core in eps"


def assert_labels_conformant(points: np.ndarray, eps: float, min_pts: int,
                             labels_ref: np.ndarray,
                             labels_got: np.ndarray,
                             core: np.ndarray | None = None) -> None:
    """Strictest meaningful engine-equality check.

    1. DBSCAN-equivalence (core partition, noise set, border validity)
       via :func:`assert_dbscan_equivalent`.
    2. Label-for-label equality after ``canonicalize_labels`` on every
       point whose output DBSCAN defines uniquely -- i.e. everything
       except *contested* borders (non-core points within eps of cores
       of more than one cluster, which Alg. 6 assigns order-dependently).
    """
    from .dbscan import canonicalize_labels

    pts = np.asarray(points, np.float64)
    if core is None:
        core = core_flags(pts, eps, min_pts)
    la, lb = np.asarray(labels_ref), np.asarray(labels_got)
    assert_dbscan_equivalent(pts, eps, min_pts, la, lb, core=core)
    contested = contested_border_mask(pts, eps, core, la)
    m = ~contested
    np.testing.assert_array_equal(
        canonicalize_labels(la[m]), canonicalize_labels(lb[m]),
        err_msg="canonicalized labels differ on uncontested points")


# --------------------------------------------------------------------------
# the chunked float64 brute check on a device
# --------------------------------------------------------------------------

#: bytes of temporaries one (query, candidate) pair of a block takes: the
#: float64 sum and one float64 term, the mask and its reductions
BRUTE_PAIR_BYTES = 24


def _brute_device(device) -> torch.device:
    """The port's device rule: ``None`` is the card, and raises without
    one; anything else is used as given (a CUDA device never falls back
    to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the GPU "
                "by default; pass device=\"cpu\" to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _brute_plan(lo: np.ndarray, hi: np.ndarray, budget: int) -> list:
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


def _brute_within(q: torch.Tensor, c: torch.Tensor, eps2: float):
    """``Σ_k (q_k − c_k)²  <=  eps²`` for every (row, column) pair, in
    float64, summed in k order as ``brute_dbscan`` sums it."""
    d2 = None
    for k in range(q.shape[1]):
        t = q[:, None, k] - c[None, :, k]
        t.mul_(t)
        d2 = t if d2 is None else d2.add_(t)
    return d2 <= eps2


def _brute_windows(qkey, ckey, r):
    return (torch.searchsorted(ckey, qkey - r, side="left"),
            torch.searchsorted(ckey, qkey + r, side="right"))


def _brute_canonical(lab: torch.Tensor) -> torch.Tensor:
    """``canonicalize_labels`` on a device: clusters renumbered by first
    occurrence, noise stays -1."""
    out = torch.full_like(lab, -1)
    pos = torch.nonzero(lab >= 0)[:, 0]
    if pos.numel():
        _, inv = torch.unique(lab[pos], return_inverse=True)
        k = int(inv.max().item()) + 1
        first = torch.full((k,), lab.numel(), dtype=torch.int64,
                           device=lab.device)
        first.scatter_reduce_(0, inv, pos, "amin")
        rank = torch.empty_like(first)
        rank[torch.argsort(first)] = torch.arange(k, device=lab.device)
        out[pos] = rank[inv]
    return out


def _brute_first(mask: torch.Tensor, ids: torch.Tensor) -> int:
    """The least original index among the rows ``mask`` marks."""
    return int(ids[mask].min().item())


def check_conformant_brute(points, eps: float, min_pts: int, labels, core,
                           *, device=None, budget_bytes: int = 2 << 30
                           ) -> dict:
    """Check a labelling and its core flags against brute DBSCAN.

    What ``brute_dbscan`` and ``assert_labels_conformant`` compute
    together, in float64 on ``device`` (``None``: the card, raising
    without one; ``"cpu"`` runs the same code on the CPU), at any n that
    fits the device:

    1. neighbour counts including self (``Σ(a−b)² <= eps²``); a point is
       core iff its count >= ``min_pts``.  The points are sorted by their
       first coordinate, and each chunk of consecutive queries scans only
       the contiguous window within ``eps`` of it on that coordinate
       (``torch.searchsorted``); chunk x window blocks hold at most
       ``budget_bytes`` of temporaries (``BRUTE_PAIR_BYTES`` a pair);
    2. the core–core pairs within eps: counted in one sweep, then
       allocated and filled in another;
    3. the components of that graph: min-label hooking and pointer
       jumping to a fixed point;
    4. per non-core point, whether a core lies within eps, the least and
       greatest component among those cores (contested when they
       differ), and whether the cluster of its given label owns one.

    Then the reference's checks, with its messages: core flags equal;
    the given labels of the cores one-to-one with the components ("core-
    point partitions differ"); noise sets equal; every border assignment
    valid; labels equal after ``canonicalize_labels`` on every
    uncontested point.  No tolerance anywhere.  Raises
    ``AssertionError`` on the first check that fails; returns the
    counts of the run (n, cores, clusters, contested, noise, pairs
    evaluated per sweep, core–core pairs and their bytes, propagation
    rounds, seconds per stage); each stage prints a line on stderr.
    """
    dev = _brute_device(device)

    def say(line):
        print(line, file=sys.stderr, flush=True)

    t_start = time.perf_counter()
    secs = {}

    def lap(stage, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[stage] = time.perf_counter() - t0
        return time.perf_counter()

    pts_np = np.asarray(points, np.float64)
    lab_np = np.asarray(labels)
    core_np = np.asarray(core, bool)
    n, d = pts_np.shape
    if lab_np.shape != (n,) or core_np.shape != (n,):
        raise ValueError(f"labels {lab_np.shape} and core {core_np.shape} "
                         f"must both be ({n},)")
    eps2 = float(eps) ** 2
    budget = max(1, int(budget_bytes) // BRUTE_PAIR_BYTES)
    t0 = time.perf_counter()
    pts = torch.as_tensor(pts_np, device=dev)
    given = torch.as_tensor(lab_np.astype(np.int64), device=dev)
    given_core = torch.as_tensor(core_np, device=dev)
    order = torch.argsort(pts[:, 0], stable=True)
    sp = pts[order].contiguous()
    key = sp[:, 0].contiguous()
    # the window's half width: eps, widened past any rounding of x ± r
    r = float(eps) * (1.0 + 1e-9) + 1e-12 * float(np.abs(pts_np).max())
    lo, hi = _brute_windows(key, key, r)
    t0 = lap("sort", t0)

    # (1) neighbour counts, every point against its window
    plan = _brute_plan(lo.cpu().numpy(), hi.cpu().numpy(), budget)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    for s, e, c0, c1 in plan:
        counts[s:e] += _brute_within(sp[s:e], sp[c0:c1], eps2).sum(1)
    pairs = {"count": sum((e - s) * (c1 - c0) for s, e, c0, c1 in plan)}
    core_s = counts >= min_pts
    t0 = lap("count", t0)
    say(f"brute: n={n} d={d} count sweep {pairs['count']:,} pairs in "
        f"{len(plan)} blocks, {secs['count']:.3f} s")
    flips = core_s != given_core[order]
    if bool(flips.any()):
        raise AssertionError(
            f"core flags differ from the brute recomputation on "
            f"{int(flips.sum().item())} points (first "
            f"{_brute_first(flips, order)})")

    # (2) the core-core pairs within eps (j > i in key order)
    cpos = torch.nonzero(core_s)[:, 0]
    nc = int(cpos.numel())
    cp = sp[cpos].contiguous()
    cids = order[cpos]
    clo, chi = _brute_windows(cp[:, 0].contiguous(), cp[:, 0].contiguous(), r)
    clo = torch.maximum(clo, torch.arange(1, nc + 1, device=dev))
    cplan = _brute_plan(clo.cpu().numpy(), chi.cpu().numpy(), budget)

    def upper(s, e, c0, c1):
        w = _brute_within(cp[s:e], cp[c0:c1], eps2)
        return w & (torch.arange(c0, c1, device=dev)[None, :]
                    > torch.arange(s, e, device=dev)[:, None])

    per_block = torch.stack([upper(*b).sum() for b in cplan]).cpu().numpy() \
        if cplan else np.zeros(0, np.int64)
    n_pairs = int(per_block.sum())
    pairs["core_pairs_count"] = sum((e - s) * (c1 - c0)
                                    for s, e, c0, c1 in cplan)
    say(f"brute: {nc:,} cores, {n_pairs:,} core-core pairs within eps, "
        f"{16 * n_pairs:,} bytes")
    u = torch.empty(n_pairs, dtype=torch.int64, device=dev)
    v = torch.empty(n_pairs, dtype=torch.int64, device=dev)
    at, pairs["core_pairs_fill"] = 0, 0
    for (s, e, c0, c1), k in zip(cplan, per_block.tolist()):
        if k:
            rc = torch.nonzero(upper(s, e, c0, c1))
            u[at:at + k] = rc[:, 0] + s
            v[at:at + k] = rc[:, 1] + c0
            at += k
            pairs["core_pairs_fill"] += (e - s) * (c1 - c0)
    t0 = lap("core_pairs", t0)

    # (3) components: min-label hooking + pointer jumping
    comp = torch.arange(nc, device=dev)
    rounds = 0
    while n_pairs:
        rounds += 1
        prev = comp.clone()
        fu, fv = comp[u], comp[v]
        m = torch.minimum(fu, fv)
        comp.scatter_reduce_(0, fu, m, "amin")
        comp.scatter_reduce_(0, fv, m, "amin")
        while True:
            nxt = comp[comp]
            if torch.equal(nxt, comp):
                break
            comp = nxt
        if torch.equal(comp, prev):
            break
    n_clusters = int((comp == torch.arange(nc, device=dev)).sum().item())
    t0 = lap("components", t0)
    say(f"brute: {n_clusters:,} components in {rounds} rounds, "
        f"{secs['components']:.3f} s")

    # (4) every non-core point against the cores of its window
    npos = torch.nonzero(~core_s)[:, 0]
    qp = sp[npos].contiguous()
    nids = order[npos]
    qlab = given[nids]
    clab = given[cids]
    nlo, nhi = _brute_windows(qp[:, 0].contiguous(), cp[:, 0].contiguous(), r)
    bplan = _brute_plan(nlo.cpu().numpy(), nhi.cpu().numpy(), budget)
    nn = int(npos.numel())
    has = torch.zeros(nn, dtype=torch.bool, device=dev)
    owned = torch.zeros(nn, dtype=torch.bool, device=dev)
    big = torch.iinfo(torch.int64).max
    cmin = torch.full((nn,), big, dtype=torch.int64, device=dev)
    cmax = torch.full((nn,), -1, dtype=torch.int64, device=dev)
    for s, e, c0, c1 in bplan:
        w = _brute_within(qp[s:e], cp[c0:c1], eps2)
        has[s:e] |= w.any(1)
        cc = comp[c0:c1][None, :]
        cmin[s:e] = torch.minimum(cmin[s:e], torch.where(w, cc, big).amin(1))
        cmax[s:e] = torch.maximum(cmax[s:e], torch.where(w, cc, -1).amax(1))
        owned[s:e] |= (w & (clab[c0:c1][None, :] == qlab[s:e, None])).any(1)
    pairs["border"] = sum((e - s) * (c1 - c0) for s, e, c0, c1 in bplan)
    contested = has & (cmin != cmax)
    t0 = lap("border", t0)

    # the reference's checks, labelling B the one given
    if bool((clab < 0).any()):
        raise AssertionError("labeling B: core point marked noise")
    key2 = clab * max(nc, 1) + comp
    if not (torch.unique(key2).numel() == torch.unique(clab).numel()
            == n_clusters):
        raise AssertionError("core-point partitions differ")
    bad = has & (qlab < 0)
    if bool(bad.any()):
        raise AssertionError(f"labeling B: border point "
                             f"{_brute_first(bad, nids)} marked noise")
    bad = ~has & (qlab >= 0)
    if bool(bad.any()):
        raise AssertionError(f"labeling B: noise point "
                             f"{_brute_first(bad, nids)} in a cluster")
    empty = (qlab >= 0) & ~torch.isin(qlab, clab)
    bad = (qlab >= 0) & ~owned
    if bool(bad.any()):
        i = _brute_first(bad, nids)
        if bool(empty[nids == i].any()):
            raise AssertionError(f"labeling B: border {i} in empty cluster")
        raise AssertionError(f"labeling B: border {i} assigned to cluster "
                             f"w/o core in eps")
    brute = torch.full((n,), -1, dtype=torch.int64, device=dev)
    brute[cids] = comp
    brute[nids] = torch.where(has, cmin, -1)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[nids] = ~contested
    if not torch.equal(_brute_canonical(brute[keep]),
                       _brute_canonical(given[keep])):
        raise AssertionError(
            "canonicalized labels differ on uncontested points")
    lap("checks", t0)
    secs["total"] = time.perf_counter() - t_start
    report = dict(
        n=n, d=d, cores=nc, clusters=n_clusters,
        border=int(has.sum().item()), contested=int(contested.sum().item()),
        noise=int((~has).sum().item()), pairs_evaluated=pairs,
        pairs_total=sum(pairs.values()), core_core_pairs=n_pairs,
        core_core_bytes=16 * n_pairs, rounds=rounds,
        blocks=dict(count=len(plan), core_pairs=len(cplan),
                    border=len(bplan)),
        budget_bytes=int(budget_bytes), device=str(dev), seconds=secs)
    say(f"brute: conformant: {report['clusters']:,} clusters, "
        f"{report['contested']:,} contested, {report['noise']:,} noise, "
        f"{secs['total']:.3f} s")
    return report
