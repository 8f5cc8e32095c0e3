"""Scenario catalogue of the port: one set of datasets for conformance
tests and for the on-card smoke run.

Each :class:`Scenario` bundles a generator with the (eps, min_pts) that
make it interesting: exact equivalence against a sequential oracle
across a *grid* of adversarial shapes, not just happy blobs.  The
catalogue covers:

* gaussian blobs at every supported dimensionality d in {1..5},
* dense/sparse uniform boxes (one giant cluster / all-noise),
* 2-D moons and concentric rings (non-convex clusters),
* collinear and exactly-duplicated points (degenerate geometry),
* a single-grid blob (the all-core shortcut path),
* chains with gaps placed just inside/outside eps (merge threshold),
* lattices jittered against the grid side eps/sqrt(d) (identifier
  boundary behaviour),
* a cross-slab snake spanning the whole dim-0 extent.

Deliberate margins: threshold scenarios place gaps at a relative margin
(default 1e-3) away from eps so float32 device engines and the float64
host oracle land on the same side of every comparison.  DBSCAN itself is
discontinuous at exact equality; testing *at* the knife edge tests the
rounding mode, not the algorithm.

Domain is [0, DOMAIN]^d (the paper's normalized integer domain).  The
generators are numpy and draw the same numbers from the same seed as
``repro.data.scenarios``, so both packages can be held to each other
on identical inputs.

Serving workloads (:class:`ServingScenario`, ``serving_scenarios()``)
layer fit-once / serve-many traffic on top of the catalogue: a base fit
set plus held-out query batches (near-cluster, empty-grid,
outside-the-fitted-box and exact-eps-boundary queries) and streaming
micro-batch inserts that drift outside the fitted bounding box.
``dist_serving_scenarios()`` are the sharded-serving variants: traffic
engineered at the slab cut bands (queries that must consult two shards,
inserts whose blobs straddle a cut and whose merges need cross-shard
re-reconciliation).
Churn workloads (:class:`ChurnScenario`, ``churn_scenarios()``) add the
delete direction: interleaved insert/delete op streams at DBSCAN's
non-monotone spots (bridge cuts that split a cluster, thinning that
demotes cores, deletes below the shifted identifier origin, TTL
windows).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .seed_spreader import seed_spreader, DOMAIN


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named dataset + the DBSCAN parameters it should be run with."""

    name: str
    d: int
    n: int
    eps: float
    min_pts: int
    gen: Callable[[np.random.Generator, int, int], np.ndarray]
    tags: Tuple[str, ...] = ()

    def points(self, seed: int = 0, n: Optional[int] = None) -> np.ndarray:
        """Generate the dataset ([n, d] float64, inside [0, DOMAIN]^d)."""
        rng = np.random.default_rng(seed)
        pts = self.gen(rng, n or self.n, self.d)
        assert pts.shape == (n or self.n, self.d), \
            f"{self.name}: generator returned {pts.shape}"
        return np.clip(np.asarray(pts, np.float64), 0.0, DOMAIN)

    def has(self, tag: str) -> bool:
        return tag in self.tags


# --------------------------------------------------------------------------
# generators
# --------------------------------------------------------------------------

def _blobs(rng: np.random.Generator, n: int, d: int, k: int = 4,
           spread: float = 900.0) -> np.ndarray:
    """k gaussian blobs + 5% uniform noise."""
    n_noise = max(n // 20, 1)
    centers = rng.uniform(0.15 * DOMAIN, 0.85 * DOMAIN, size=(k, d))
    which = rng.integers(0, k, size=n - n_noise)
    pts = centers[which] + rng.normal(scale=spread, size=(n - n_noise, d))
    noise = rng.uniform(0, DOMAIN, size=(n_noise, d))
    return np.concatenate([pts, noise])


def _uniform(rng: np.random.Generator, n: int, d: int,
             box: float) -> np.ndarray:
    lo = (DOMAIN - box) / 2
    return lo + rng.uniform(0, box, size=(n, d))


def _moons(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Two interleaved half-circles (classic non-convex pair)."""
    assert d == 2
    m = n // 2
    t1 = rng.uniform(0, np.pi, size=m)
    t2 = rng.uniform(0, np.pi, size=n - m)
    r = 0.25 * DOMAIN
    a = np.stack([r * np.cos(t1), r * np.sin(t1)], axis=1)
    b = np.stack([r - r * np.cos(t2), -r * np.sin(t2) + 0.35 * r], axis=1)
    pts = np.concatenate([a, b]) + rng.normal(scale=0.01 * r, size=(n, 2))
    return pts + 0.5 * DOMAIN - np.array([r / 2, 0.0])


def _rings(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Two concentric annuli around the domain center."""
    assert d == 2
    m = n // 2
    theta = rng.uniform(0, 2 * np.pi, size=n)
    radii = np.concatenate([
        np.full(m, 0.12 * DOMAIN), np.full(n - m, 0.30 * DOMAIN)])
    radii = radii * (1 + rng.uniform(-0.03, 0.03, size=n))
    pts = np.stack([radii * np.cos(theta), radii * np.sin(theta)], axis=1)
    return pts + 0.5 * DOMAIN


def _collinear(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Points on a 1-D line embedded in R^d: two dense segments with a
    wide gap, plus a handful of isolated (noise) points on the same line."""
    n_seg = (n - 4) // 2
    step = 300.0
    a = np.arange(n_seg) * step + 0.1 * DOMAIN
    b = np.arange(n - 4 - n_seg) * step + 0.6 * DOMAIN
    iso = np.linspace(0.45 * DOMAIN, 0.55 * DOMAIN, 4)
    x = np.concatenate([a, b, iso])
    pts = np.zeros((n, d))
    pts[:, 0] = x
    if d > 1:
        pts[:, 1:] = 0.5 * DOMAIN     # constant: exactly collinear
    return pts


def _duplicates(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """A few exact locations repeated many times (zero distances, ties)
    plus singleton outliers that must come out as noise."""
    k = 5
    centers = rng.uniform(0.2 * DOMAIN, 0.8 * DOMAIN, size=(k, d))
    n_iso = min(8, n // 10)
    reps = (n - n_iso) // k
    pts = np.repeat(centers, reps, axis=0)
    iso = rng.uniform(0, DOMAIN, size=(n - len(pts), d))
    return np.concatenate([pts, iso])


def _single_grid(rng: np.random.Generator, n: int, d: int,
                 eps: float) -> np.ndarray:
    """Everything inside ONE grid cell (side eps/sqrt(d)): exercises the
    all-core shortcut and the one-grid degenerate tree."""
    side = eps / np.sqrt(d)
    lo = 0.5 * DOMAIN
    # strictly interior so f32/f64 floor() agree on the cell
    return lo + side * 0.1 + rng.uniform(0, side * 0.8, size=(n, d))


def _eps_chain(rng: np.random.Generator, n: int, d: int, eps: float,
               margin: float = 1e-3) -> np.ndarray:
    """A chain along dim 0 with steps alternating just-below eps, and one
    single break just-above eps in the middle: exactly two clusters.

    The margin keeps every pairwise comparison decidable in float32
    (DBSCAN is discontinuous at exact equality; see module docstring).
    """
    steps = np.full(n - 1, eps * (1 - margin))
    steps[n // 2] = eps * (1 + margin)
    x = np.concatenate([[0.0], np.cumsum(steps)]) + 0.05 * DOMAIN
    pts = np.zeros((n, d))
    pts[:, 0] = x
    if d > 1:
        pts[:, 1:] = 0.5 * DOMAIN + rng.normal(scale=eps * 0.01,
                                               size=(n, d - 1))
    return pts


def _grid_boundary_lattice(rng: np.random.Generator, n: int, d: int,
                           eps: float) -> np.ndarray:
    """Points jittered around multiples of ~the grid side eps/sqrt(d), so
    many land a hair from identifier boundaries: adversarial for the
    partition (floor) step while distances stay comfortably decidable.

    Spacing is 0.95 * side, NOT side exactly: at spacing == side the
    lattice diagonal equals eps to within float rounding (side**2 * d ==
    eps**2), which would make core-ness a knife-edge f32-vs-f64 call."""
    side = eps / np.sqrt(d)
    m = int(np.ceil(n ** (1 / d)))
    axes = [np.arange(m) * side * 0.95 for _ in range(d)]
    mesh = np.meshgrid(*axes, indexing="ij")
    lattice = np.stack([g.ravel() for g in mesh], axis=1)[:n]
    jitter = rng.choice([-1.0, 1.0], size=lattice.shape) * side * 2e-3
    return lattice + jitter + 0.3 * DOMAIN


def _cross_slab_snake(rng: np.random.Generator, n: int, d: int
                      ) -> np.ndarray:
    """One long connected snake spanning the whole dim-0 extent (crosses
    every slab boundary of the distributed sharding) + uniform noise."""
    n_noise = max(n // 10, 1)
    m = n - n_noise
    t = np.linspace(0, 1, m)
    pts = np.zeros((m, d))
    pts[:, 0] = t * DOMAIN
    if d > 1:
        pts[:, 1] = 0.5 * DOMAIN + 0.1 * DOMAIN * np.sin(6 * t)
    if d > 2:
        pts[:, 2:] = 0.5 * DOMAIN
    pts += rng.normal(scale=300.0, size=pts.shape)
    noise = rng.uniform(0, DOMAIN, size=(n_noise, d))
    return np.concatenate([pts, noise])


def _seed_spreader(variant: str, restarts: int):
    def gen(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
        # seed_spreader manages its own rng; derive a seed from ours
        return seed_spreader(n, d, variant=variant, restarts=restarts,
                             seed=int(rng.integers(2 ** 31)))
    return gen


# --------------------------------------------------------------------------
# the catalogue
# --------------------------------------------------------------------------

def default_scenarios() -> List[Scenario]:
    """The cross-engine conformance / benchmark matrix.

    Tags:
      quick  -- in the default (non-slow) device conformance subset
      slab   -- spans shard boundaries; exercised by the distributed path
      degenerate -- geometry edge cases (duplicates, collinear, 1-D)
    """
    s: List[Scenario] = []

    for d in (1, 2, 3, 4, 5):
        s.append(Scenario(
            name=f"blobs-{d}d", d=d, n=220, eps=2500.0, min_pts=6,
            gen=lambda rng, n, dd: _blobs(rng, n, dd),
            tags=("quick",) if d == 3 else ()))

    s.append(Scenario(
        name="uniform-dense-2d", d=2, n=256, eps=9000.0, min_pts=5,
        gen=lambda rng, n, d: _uniform(rng, n, d, box=0.5 * DOMAIN)))
    s.append(Scenario(
        name="all-noise-3d", d=3, n=160, eps=800.0, min_pts=5,
        gen=lambda rng, n, d: _uniform(rng, n, d, box=DOMAIN)))

    s.append(Scenario(
        name="moons-2d", d=2, n=240, eps=2200.0, min_pts=5, gen=_moons))
    s.append(Scenario(
        name="rings-2d", d=2, n=240, eps=3500.0, min_pts=5, gen=_rings))

    s.append(Scenario(
        name="collinear-3d", d=3, n=200, eps=1000.0, min_pts=4,
        gen=_collinear, tags=("degenerate",)))
    s.append(Scenario(
        name="duplicates-2d", d=2, n=200, eps=1500.0, min_pts=5,
        gen=_duplicates, tags=("degenerate",)))
    s.append(Scenario(
        name="line-1d", d=1, n=150, eps=1200.0, min_pts=4,
        gen=_collinear, tags=("degenerate",)))

    s.append(Scenario(
        name="single-grid-3d", d=3, n=180, eps=4000.0, min_pts=6,
        gen=lambda rng, n, d: _single_grid(rng, n, d, eps=4000.0)))

    s.append(Scenario(
        name="eps-chain-2d", d=2, n=64, eps=1200.0, min_pts=2,
        gen=lambda rng, n, d: _eps_chain(rng, n, d, eps=1200.0)))
    s.append(Scenario(
        name="grid-boundary-2d", d=2, n=225, eps=3000.0, min_pts=4,
        gen=lambda rng, n, d: _grid_boundary_lattice(rng, n, d, eps=3000.0)))

    s.append(Scenario(
        name="cross-slab-2d", d=2, n=320, eps=2500.0, min_pts=5,
        gen=_cross_slab_snake, tags=("slab", "quick")))
    s.append(Scenario(
        name="cross-slab-3d", d=3, n=320, eps=3000.0, min_pts=5,
        gen=_cross_slab_snake, tags=("slab",)))

    s.append(Scenario(
        name="varden-3d", d=3, n=300, eps=4000.0, min_pts=8,
        gen=_seed_spreader("varden", restarts=4)))
    s.append(Scenario(
        name="simden-5d", d=5, n=300, eps=4000.0, min_pts=8,
        gen=_seed_spreader("simden", restarts=4)))

    return s


# --------------------------------------------------------------------------
# serving scenarios: base fit set + held-out query / insert traffic
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingScenario:
    """A fit-once / serve-many workload over a base :class:`Scenario`.

    ``query_batch`` produces held-out point queries against the fitted
    index (the predict plane); ``insert_batches`` produces a stream of
    micro-batches (the insert plane).  Both are deterministic in the
    seed, like the base catalogue.
    """

    name: str
    base: Scenario
    n_query: int
    n_insert: int                   # points per insert batch
    query_gen: Callable[[np.random.Generator, np.ndarray, "Scenario", int],
                        np.ndarray]
    insert_gen: Callable[[np.random.Generator, np.ndarray, "Scenario",
                          int, int, int], np.ndarray]
    insert_steps: int = 3
    tags: Tuple[str, ...] = ("serving",)

    def fit_points(self, seed: int = 0) -> np.ndarray:
        return self.base.points(seed)

    def query_batch(self, seed: int = 0, n: Optional[int] = None
                    ) -> np.ndarray:
        rng = np.random.default_rng(10_000 + seed)
        q = self.query_gen(rng, self.fit_points(seed), self.base,
                           n or self.n_query)
        assert q.shape == (n or self.n_query, self.base.d)
        return np.asarray(q, np.float64)

    def insert_batches(self, seed: int = 0,
                       steps: Optional[int] = None) -> List[np.ndarray]:
        rng = np.random.default_rng(20_000 + seed)
        base = self.fit_points(seed)
        k = steps or self.insert_steps
        return [np.asarray(
            self.insert_gen(rng, base, self.base, self.n_insert, t, k),
            np.float64) for t in range(k)]


def _queries_mixed(rng: np.random.Generator, base: np.ndarray,
                   sc: Scenario, n: int) -> np.ndarray:
    """Held-out predict traffic covering every assignment regime:

    * near-duplicates of fitted points (deep inside clusters),
    * uniform points over an *extended* box -- many land in empty grids
      or outside the fitted bounding box (negative identifiers),
    * a ring at 0.5..2 eps from fitted points (the border/noise band,
      kept a relative margin away from eps itself),
    * queries placed *exactly* on the eps boundary of a fitted point
      (one axis-aligned eps step: distance == eps up to one rounding of
      the f64 sum, landing as close to the <=-vs-> knife edge as f64
      allows -- predict and oracle must still agree bit-for-bit because
      both evaluate the identical f64 expression).
    """
    d = sc.d
    n_near = int(0.4 * n)
    n_far = int(0.25 * n)
    n_ring = int(0.2 * n)
    n_edge = n - n_near - n_far - n_ring
    near = base[rng.integers(0, len(base), n_near)] + rng.normal(
        scale=0.1 * sc.eps, size=(n_near, d))
    far = rng.uniform(-0.15 * DOMAIN, 1.15 * DOMAIN, size=(n_far, d))
    anchors = base[rng.integers(0, len(base), n_ring)]
    dirs = rng.normal(size=(n_ring, d))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.5, 2.0, size=(n_ring, 1)) * sc.eps
    # stay a relative margin off eps so f32 predict modes agree too
    radii = np.where(np.abs(radii - sc.eps) < 1e-3 * sc.eps,
                     sc.eps * (1 + 2e-3), radii)
    ring = anchors + dirs * radii
    edge_anchor = base[rng.integers(0, len(base), n_edge)]
    axis = rng.integers(0, d, n_edge)
    edge = edge_anchor.copy()
    edge[np.arange(n_edge), axis] += sc.eps
    return np.concatenate([near, far, ring, edge])


def _insert_drift(rng: np.random.Generator, base: np.ndarray,
                  sc: Scenario, n: int, step: int, steps: int
                  ) -> np.ndarray:
    """Streaming drift: each micro-batch is a blob whose center walks
    from inside the fitted region off past the corner of the domain
    (later batches fall *outside* the fitted bounding box, exercising
    the identifier-origin shift), plus a sprinkle of points landing on
    the fitted clusters (growing/merging existing structure)."""
    d = sc.d
    t = (step + 1) / steps
    center = ((1 - t) * 0.5 * DOMAIN
              + t * 1.12 * DOMAIN) * np.ones(d)
    n_blob = int(0.7 * n)
    blob = center + rng.normal(scale=1.5 * sc.eps, size=(n_blob, d))
    onto = base[rng.integers(0, len(base), n - n_blob)] + rng.normal(
        scale=0.4 * sc.eps, size=(n - n_blob, d))
    return np.concatenate([blob, onto])


def _quantile_cuts(base: np.ndarray, k: int = 3) -> np.ndarray:
    """Approximate slab-cut dim-0 coordinates: the equal-count cut
    policy puts them near the interior count quantiles."""
    x0 = np.sort(base[:, 0])
    return x0[[(i * len(x0)) // (k + 1) for i in range(1, k + 1)]]


def _queries_slab_band(rng: np.random.Generator, base: np.ndarray,
                       sc: Scenario, n: int) -> np.ndarray:
    """Distributed-serving predict traffic: half the mixed catalogue
    regimes (near / far / eps-ring / exact-eps), half aimed at the slab
    *cut bands* -- dim-0 coordinates within ~2.5 eps of the equal-count
    quantile lines, where the sharded router must consult both
    neighboring shards and still match the brute rule bit-for-bit."""
    n_mix = n // 2
    mix = _queries_mixed(rng, base, sc, n_mix)
    cuts = _quantile_cuts(base)
    band = base[rng.integers(0, len(base), n - n_mix)].copy()
    which = rng.integers(0, len(cuts), n - n_mix)
    band[:, 0] = cuts[which] + rng.uniform(-2.5, 2.5,
                                           n - n_mix) * sc.eps
    return np.concatenate([mix, band])


def _insert_slab_drift(rng: np.random.Generator, base: np.ndarray,
                       sc: Scenario, n: int, step: int, steps: int
                       ) -> np.ndarray:
    """Distributed-serving insert traffic: blobs centered ON a cut line
    (cross-shard structure: new cores on both sides, merges witnessed
    by shared points), bridges between random fitted pairs (label
    splices that may span slabs), plus a dim-0 drift component walking
    past the domain edge (identifier-origin shifts inside end slabs)."""
    d = sc.d
    cuts = _quantile_cuts(base)
    cut = cuts[step % len(cuts)]
    n_cut = int(0.4 * n)
    n_bridge = int(0.3 * n)
    n_drift = n - n_cut - n_bridge
    center = np.full(d, 0.5 * DOMAIN)
    center[0] = cut
    if d > 1:
        center[1:] = base[rng.integers(0, len(base)), 1:]
    blob = center + rng.normal(scale=1.2 * sc.eps, size=(n_cut, d))
    a, b = base[rng.integers(0, len(base), (2, n_bridge))]
    bridge = a + rng.uniform(0, 1, size=(n_bridge, 1)) * (b - a)
    t = (step + 1) / steps
    dcen = np.full(d, 0.5 * DOMAIN)
    dcen[0] = (1 - t) * 0.5 * DOMAIN + t * 1.15 * DOMAIN
    drift = dcen + rng.normal(scale=1.5 * sc.eps, size=(n_drift, d))
    return np.concatenate([blob, bridge, drift])


# --------------------------------------------------------------------------
# churn scenarios: interleaved insert/delete op streams
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChurnScenario:
    """A base fit plus a deterministic interleaved mutation stream.

    :meth:`ops` yields ``("insert", points)`` / ``("delete",
    arrival_ids)`` pairs; arrival ids are *global*: the base fit takes
    ``0..n-1`` and every insert appends ids in submission order --
    exactly the id discipline of ``GritIndex`` / ``ShardedGritIndex``
    (ids are never reused, deletes may target any earlier op's
    points).  Deterministic in the seed, like the rest of the
    catalogue.
    """

    name: str
    base: Scenario
    plan: Callable[[np.random.Generator, np.ndarray, Scenario],
                   List[Tuple[str, np.ndarray]]]
    tags: Tuple[str, ...] = ("churn",)

    def fit_points(self, seed: int = 0) -> np.ndarray:
        return self.base.points(seed)

    def ops(self, seed: int = 0) -> List[Tuple[str, np.ndarray]]:
        rng = np.random.default_rng(30_000 + seed)
        out = self.plan(rng, self.fit_points(seed), self.base)
        for kind, payload in out:
            assert kind in ("insert", "delete"), kind
        return out


def _plan_churn_split(rng: np.random.Generator, base: np.ndarray,
                      sc: Scenario) -> List[Tuple[str, np.ndarray]]:
    """The non-monotone corners, one op each: build two blobs + a dense
    bridge (one merged cluster), cut the bridge (split in two), empty
    one grid-sized box of the base set, insert below the fitted origin
    (id_shift) then delete half of those, and thin a blob below MinPts
    (core -> border/noise demotions)."""
    eps, mp = sc.eps, sc.min_pts
    ops: List[Tuple[str, np.ndarray]] = []
    nid = len(base)

    def ins(pts: np.ndarray) -> np.ndarray:
        nonlocal nid
        ids = np.arange(nid, nid + len(pts), dtype=np.int64)
        nid += len(pts)
        ops.append(("insert", np.asarray(pts, np.float64)))
        return ids

    c = np.full(2, 0.5 * DOMAIN)
    off = np.array([4.0 * eps, 0.0])
    left = ins((c - off) + rng.normal(scale=0.3 * eps,
                                      size=(4 * mp, 2)))
    ins((c + off) + rng.normal(scale=0.3 * eps, size=(4 * mp, 2)))
    t = np.linspace(0.0, 1.0, 8 * mp)[:, None]
    bridge = ins((c - off) + t * (2 * off)
                 + rng.normal(scale=0.05 * eps, size=(8 * mp, 2)))
    ops.append(("delete", bridge))          # bridge cut: cluster splits
    side = eps / np.sqrt(2.0)
    lo = np.quantile(base, 0.4, axis=0)
    in_box = np.flatnonzero(
        ((base >= lo) & (base < lo + side)).all(axis=1))
    ops.append(("delete", in_box))          # one whole grid emptied
    below = ins(base.min(axis=0) - 10 * eps
                + rng.uniform(0, eps, size=(3 * mp, 2)))
    ops.append(("delete", below[::2]))      # delete below shifted origin
    ops.append(("delete", left[: 3 * mp]))  # thin a blob: demotions
    return ops


def _plan_ttl_drift(rng: np.random.Generator, base: np.ndarray,
                    sc: Scenario, steps: int = 4
                    ) -> List[Tuple[str, np.ndarray]]:
    """TTL sliding window over a drifting stream: each step inserts a
    blob walking off past the domain corner (outside the fitted box:
    identifier-origin shifts) plus on-cluster points, then expires the
    oldest as many live points -- the window eventually erases entire
    original grids while the drift keeps opening new ones."""
    eps, d = sc.eps, sc.d
    ops: List[Tuple[str, np.ndarray]] = []
    nid = len(base)
    live: List[int] = list(range(len(base)))
    for step in range(steps):
        t = (step + 1) / steps
        center = ((1 - t) * 0.5 + t * 1.12) * DOMAIN * np.ones(d)
        blob = center + rng.normal(scale=1.5 * eps, size=(40, d))
        onto = base[rng.integers(0, len(base), 16)] + rng.normal(
            scale=0.4 * eps, size=(16, d))
        pts = np.concatenate([blob, onto])
        ops.append(("insert", pts))
        ids = list(range(nid, nid + len(pts)))
        nid += len(pts)
        live += ids
        expire, live = live[:len(pts)], live[len(pts):]
        ops.append(("delete", np.asarray(expire, np.int64)))
    return ops


def churn_scenarios() -> List[ChurnScenario]:
    """Interleaved insert/delete workloads for the mutation-plane
    tests."""
    base = scenario_map()
    return [
        ChurnScenario(name="churn-split-2d", base=base["blobs-2d"],
                      plan=_plan_churn_split,
                      tags=("churn", "split")),
        ChurnScenario(name="ttl-drift-3d", base=base["blobs-3d"],
                      plan=_plan_ttl_drift,
                      tags=("churn", "ttl")),
    ]


def churn_scenario_map() -> Dict[str, ChurnScenario]:
    return {sc.name: sc for sc in churn_scenarios()}


def get_churn_scenario(name: str) -> ChurnScenario:
    m = churn_scenario_map()
    if name not in m:
        raise KeyError(
            f"unknown churn scenario {name!r}; known: {sorted(m)}")
    return m[name]


def serving_scenarios() -> List[ServingScenario]:
    """Fit/query/insert workloads for the index + serving tests."""
    base = scenario_map()
    return [
        ServingScenario(
            name="query-heavy-3d", base=base["blobs-3d"],
            n_query=200, n_insert=48,
            query_gen=_queries_mixed, insert_gen=_insert_drift,
            tags=("serving", "query")),
        ServingScenario(
            name="drift-2d", base=base["blobs-2d"],
            n_query=120, n_insert=64, insert_steps=3,
            query_gen=_queries_mixed, insert_gen=_insert_drift,
            tags=("serving", "drift")),
    ]


def dist_serving_scenarios() -> List[ServingScenario]:
    """Distributed-serving workloads: slab-spanning fit sets with
    query/insert traffic engineered at the cut bands (the sharded
    index's routing and re-reconciliation paths)."""
    base = scenario_map()
    return [
        ServingScenario(
            name="slab-serve-2d", base=base["cross-slab-2d"],
            n_query=160, n_insert=40,
            query_gen=_queries_slab_band, insert_gen=_insert_slab_drift,
            tags=("serving", "dist-serving")),
        ServingScenario(
            name="slab-serve-3d", base=base["cross-slab-3d"],
            n_query=140, n_insert=36,
            query_gen=_queries_slab_band, insert_gen=_insert_slab_drift,
            tags=("serving", "dist-serving")),
        ServingScenario(
            name="slab-blobs-2d", base=base["blobs-2d"],
            n_query=120, n_insert=40, insert_steps=3,
            query_gen=_queries_slab_band, insert_gen=_insert_slab_drift,
            tags=("serving", "dist-serving")),
    ]


def dist_serving_scenario_map() -> Dict[str, ServingScenario]:
    return {sc.name: sc for sc in dist_serving_scenarios()}


def get_dist_serving_scenario(name: str) -> ServingScenario:
    m = dist_serving_scenario_map()
    if name not in m:
        raise KeyError(
            f"unknown distributed serving scenario {name!r}; "
            f"known: {sorted(m)}")
    return m[name]


def serving_scenario_map() -> Dict[str, ServingScenario]:
    return {sc.name: sc for sc in serving_scenarios()}


def get_serving_scenario(name: str) -> ServingScenario:
    m = serving_scenario_map()
    if name not in m:
        raise KeyError(
            f"unknown serving scenario {name!r}; known: {sorted(m)}")
    return m[name]


def scenario_map() -> Dict[str, Scenario]:
    return {sc.name: sc for sc in default_scenarios()}


def get_scenario(name: str) -> Scenario:
    m = scenario_map()
    if name not in m:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(m)}")
    return m[name]
