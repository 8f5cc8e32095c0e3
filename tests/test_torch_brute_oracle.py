"""The port's chunked float64 brute check (``core/validate.py::
check_conformant_brute``) on the CPU, held against the JAX package's
oracle: ``repro.core.dbscan.brute_dbscan`` and
``repro.core.validate.{core_flags, contested_border_mask}``.

On seeded sets of 1,500 - 5,000 points (d = 2, 3 and 7; integer and real
coordinates; duplicated points; pairs exactly eps apart; a set without a
core) the reference's own labelling and core flags pass the check, whose
counts equal the reference's (cores, clusters, noise, contested
borders); the port's host engine's labelling passes too.  Five faults
planted in a correct labelling each raise with the reference's message,
and a budget that forces many chunks gives the one-chunk result.
"""

import numpy as np
import pytest
import torch

from repro.core.dbscan import brute_dbscan
from repro.core.validate import contested_border_mask, core_flags
from repro_torch.core.validate import check_conformant_brute
from repro_torch.engine import cluster


def _blobs(rng, n, d, centers, sigma, lo, hi, noise):
    k = len(centers)
    m = n - noise
    parts = [rng.normal(c, sigma, (m // k + (i < m % k), d))
             for i, c in enumerate(centers)]
    parts.append(rng.uniform(lo, hi, (noise, d)))
    return np.concatenate(parts)


def _int_3d():
    """Three integer blobs, two of them touching through their borders."""
    rng = np.random.default_rng(1)
    c = [np.array([0, 0, 0]), np.array([150, 0, 0]), np.array([0, 400, 0])]
    return np.rint(_blobs(rng, 3000, 3, c, 40.0, -200, 600, 300)), 16.5, 10


def _real_2d():
    rng = np.random.default_rng(2)
    c = [np.array([0.0, 0.0]), np.array([2.2, 0.3]), np.array([-1.0, 3.0])]
    return _blobs(rng, 2500, 2, c, 0.6, -3, 5, 250), 0.11, 8


def _real_7d():
    rng = np.random.default_rng(3)
    c = [np.zeros(7), np.full(7, 4.0)]
    return _blobs(rng, 1500, 7, c, 1.0, -3, 7, 100), 1.9, 6


def _duplicates_2d():
    """Integer points, each of a third of them repeated 2 - 4 times."""
    rng = np.random.default_rng(4)
    c = [np.array([0, 0]), np.array([60, 10])]
    base = np.rint(_blobs(rng, 1200, 2, c, 12.0, -40, 100, 120))
    rep = base[rng.choice(len(base), 400, replace=False)]
    extra = np.repeat(rep, rng.integers(2, 5, len(rep)), axis=0)
    return np.concatenate([base, extra])[:5000], 1.5, 6


def _exact_eps_2d():
    """A lattice of spacing exactly eps (d2 == eps2 for every lattice
    edge), with holes, plus seeded points at exactly eps of a lattice
    point on a diagonal (3-4-5) and strays."""
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(np.arange(40), np.arange(40)), -1).reshape(-1, 2)
    g = g[rng.random(len(g)) > 0.15] * 5.0
    pick = g[rng.choice(len(g), 150, replace=False)]
    diag = pick + rng.choice([-1.0, 1.0], (150, 2)) * np.array([3.0, 4.0])
    stray = rng.uniform(-30, 230, (100, 2)).round()
    return np.concatenate([g, diag, stray]), 5.0, 5


def _no_core_3d():
    rng = np.random.default_rng(6)
    return rng.uniform(0, 1000, (1500, 3)), 10.0, 5


SETS = {"int-3d": _int_3d, "real-2d": _real_2d, "real-7d": _real_7d,
        "duplicates-2d": _duplicates_2d, "exact-eps-2d": _exact_eps_2d,
        "no-core-3d": _no_core_3d}
_MEMO = {}


def _reference(name):
    """Points, eps, MinPts and the JAX package's brute labels, core
    flags and contested mask, once per set."""
    if name not in _MEMO:
        pts, eps, mp = SETS[name]()
        lab = brute_dbscan(pts, eps, mp)
        core = core_flags(pts, eps, mp)
        contested = contested_border_mask(pts, eps, core, lab)
        _MEMO[name] = (pts, eps, mp, lab, core, contested)
    return _MEMO[name]


COUNTS = ("n", "d", "cores", "clusters", "border", "contested", "noise",
          "core_core_pairs")


@pytest.mark.parametrize("name", sorted(SETS))
def test_reference_labelling_passes_with_the_reference_counts(name):
    pts, eps, mp, lab, core, contested = _reference(name)
    rep = check_conformant_brute(pts, eps, mp, lab, core, device="cpu")
    assert rep["n"] == len(pts) and rep["d"] == pts.shape[1]
    assert rep["cores"] == int(core.sum())
    assert rep["clusters"] == len(np.unique(lab[lab >= 0]))
    assert rep["noise"] == int((lab < 0).sum())
    assert rep["border"] == int((~core & (lab >= 0)).sum())
    assert rep["contested"] == int(contested.sum())
    # every core-core pair within eps, counted once, from the reference's
    # own float64 distances
    cp = pts[core].astype(np.float64)
    d2 = ((cp[:, None, :] - cp[None, :, :]) ** 2).sum(-1)
    assert rep["core_core_pairs"] == int(np.triu(d2 <= eps * eps, 1).sum())
    assert rep["pairs_total"] == sum(rep["pairs_evaluated"].values())
    assert set(rep["seconds"]) >= {"sort", "count", "core_pairs",
                                   "components", "border", "checks", "total"}


def test_the_sets_cover_what_the_check_must_see():
    """Contested borders, duplicates, lattice edges at exactly eps, a
    set without a core, d = 2, 3 and 7."""
    assert _reference("int-3d")[5].sum() > 0
    assert _reference("real-2d")[5].sum() > 0
    pts = _reference("duplicates-2d")[0]
    assert len(np.unique(pts, axis=0)) < len(pts) - 300
    pts, eps, mp, lab, core, _ = _reference("exact-eps-2d")
    # a lattice point with exactly 4 lattice neighbours at eps and no
    # other point nearer is core only because d2 <= eps2 counts equality
    assert core.sum() > 0 and (core != core_flags(pts, eps * (1 - 1e-9),
                                                  mp)).any()
    assert _reference("no-core-3d")[4].sum() == 0
    assert {SETS[k]()[0].shape[1] for k in SETS} == {2, 3, 7}


@pytest.mark.parametrize("name", ["int-3d", "real-2d", "exact-eps-2d"])
def test_the_port_host_engine_passes(name):
    pts, eps, mp = SETS[name]()
    res = cluster(pts, eps, mp, engine="grit", device="cpu")
    rep = check_conformant_brute(pts, eps, mp, res.labels, res.core,
                                 device="cpu")
    assert rep["contested"] == int(_reference(name)[5].sum())


def _split(lab, core, pts):
    c = np.flatnonzero(core & (lab == lab[core].min()))
    half = c[pts[c, 0] < np.median(pts[c, 0])]
    out = lab.copy()
    out[half] = lab.max() + 1
    return out, core, "core-point partitions differ"


def _merge(lab, core, pts):
    a, b = np.unique(lab[core])[:2]
    out = lab.copy()
    out[lab == b] = a
    return out, core, "core-point partitions differ"


def _border_noise(lab, core, pts):
    i = int(np.flatnonzero(~core & (lab >= 0))[0])
    out = lab.copy()
    out[i] = -1
    return out, core, f"labeling B: border point {i} marked noise"


def _noise_labelled(lab, core, pts):
    i = int(np.flatnonzero(lab < 0)[0])
    out = lab.copy()
    out[i] = lab[core][0]
    return out, core, f"labeling B: noise point {i} in a cluster"


def _flip_core(lab, core, pts):
    i = int(np.flatnonzero(core)[7])
    out = core.copy()
    out[i] = False
    return lab, out, f"core flags differ .* on 1 points \\(first {i}\\)"


FAULTS = {"split-cluster": _split, "merged-clusters": _merge,
          "border-marked-noise": _border_noise,
          "noise-labelled": _noise_labelled, "flipped-core": _flip_core}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_raises_the_reference_message(fault):
    pts, eps, mp, lab, core, _ = _reference("int-3d")
    bad_lab, bad_core, msg = FAULTS[fault](lab, core, pts)
    with pytest.raises(AssertionError, match=msg):
        check_conformant_brute(pts, eps, mp, bad_lab, bad_core, device="cpu")


def test_many_chunks_give_the_one_chunk_result():
    pts, eps, mp, lab, core, _ = _reference("int-3d")
    one = check_conformant_brute(pts, eps, mp, lab, core, device="cpu")
    many = check_conformant_brute(pts, eps, mp, lab, core, device="cpu",
                                  budget_bytes=24 * 3000)
    assert one["blocks"] == dict(count=1, core_pairs=1, border=1)
    assert min(many["blocks"].values()) > 20, many["blocks"]
    assert {k: many[k] for k in COUNTS} == {k: one[k] for k in COUNTS}
    # a window wider than the budget allows for one row is split
    pts, eps, mp, lab, core, _ = _reference("exact-eps-2d")
    one = check_conformant_brute(pts, eps, mp, lab, core, device="cpu")
    tiny = check_conformant_brute(pts, eps, mp, lab, core, device="cpu",
                                  budget_bytes=24 * 64)
    assert tiny["blocks"]["count"] > len(pts)
    assert {k: tiny[k] for k in COUNTS} == {k: one[k] for k in COUNTS}


def test_default_device_is_the_card_and_rejects_bad_shapes():
    pts, eps, mp, lab, core, _ = _reference("no-core-3d")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check_conformant_brute(pts, eps, mp, lab, core)
    with pytest.raises(ValueError, match="must both be"):
        check_conformant_brute(pts, eps, mp, lab[:-1], core, device="cpu")
