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
"""

from __future__ import annotations

import numpy as np


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
