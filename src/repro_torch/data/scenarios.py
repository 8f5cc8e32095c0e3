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
on identical inputs.  Serving and churn workloads are not part of this
module yet.
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


def scenario_map() -> Dict[str, Scenario]:
    return {sc.name: sc for sc in default_scenarios()}


def get_scenario(name: str) -> Scenario:
    m = scenario_map()
    if name not in m:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(m)}")
    return m[name]
