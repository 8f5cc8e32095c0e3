"""The cell's inputs, made from the configuration's file and ``--seed``.

Every seed gets the same point set up to a relabelling: the points of
the configuration's generator at its fixed ``data_seed`` (rounded onto
the paper's integer domain), then, drawn from ``--seed``, a permutation
of the axes and an order of the rows.  The grid partition (its origin is
each axis's minimum), the distances, and so the clustering and its work,
are the same for every seed; coordinates, the order of the grids'
identifiers and the row order are not.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from gritbench.gen.seed_spreader import seed_spreader

GENERATORS = {"seed_spreader": seed_spreader}


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of draws of a run (any whole seed)."""
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


@lru_cache(maxsize=2)
def _base(key: tuple) -> np.ndarray:
    cfg = dict(key)
    gen = GENERATORS[cfg["generator"]]
    pts = gen(int(cfg["n"]), int(cfg["d"]), variant=cfg["variant"],
              restarts=int(cfg["restarts"]), c_reset=int(cfg["c_reset"]),
              r_vicinity=float(cfg["r_vicinity"]),
              r_shift=float(cfg["r_shift"]),
              noise_frac=float(cfg["noise_frac"]),
              seed=int(cfg["data_seed"]))
    if cfg.get("integer_coordinates", True):
        pts = np.rint(pts)
    pts.setflags(write=False)
    return pts


def base_points(cfg: dict) -> np.ndarray:
    """The configuration's point set at its ``data_seed`` (read-only)."""
    keys = ("generator", "variant", "n", "d", "restarts", "c_reset",
            "r_vicinity", "r_shift", "noise_frac", "data_seed",
            "integer_coordinates")
    return _base(tuple((k, cfg[k]) for k in keys if k in cfg))


def cell_points(cfg: dict, seed: int) -> np.ndarray:
    """[n, d] float64: the base set under this seed's permutation of the
    axes and order of the rows."""
    base = base_points(cfg)
    g = rng(seed, 0)
    axes = g.permutation(base.shape[1])
    return base[g.permutation(len(base))][:, axes]


def row_order(seed: int, k: int, n: int) -> np.ndarray:
    """The k-th fresh row order of a run."""
    return rng(seed, 1, k).permutation(n)
