"""Seed-spreader synthetic data generator (Gan & Tao, SIGMOD 2015; the
GriT-DBSCAN paper's §5.1 data).

Frozen copy of ``src/repro_torch/data/seed_spreader.py`` at commit
2a510f07d994490e1c1c2f354f6b6064be47a8b3, unchanged but for this
docstring: the same seed gives the same points as that file.

Maintains a current location; emits points uniformly in the vicinity of
the location, drifts after each burst, and with some probability restarts
at a random location (forming a new cluster).  ``varden`` scales each
cluster's vicinity radius (and thus density) by a random factor.  A small
fraction of uniform noise is added.  Domain is [0, 1e5]^d.
"""

from __future__ import annotations

import numpy as np

DOMAIN = 1e5


def seed_spreader(n: int, d: int, *, variant: str = "simden",
                  restarts: int = 10, c_reset: int = 100,
                  r_vicinity: float = 200.0, r_shift: float = 75.0,
                  noise_frac: float = 0.001,
                  seed: int = 0) -> np.ndarray:
    """Generate n points in [0, DOMAIN]^d with `restarts` clusters."""
    rng = np.random.default_rng(seed)
    n_noise = int(n * noise_frac)
    n_sig = n - n_noise
    p_restart = restarts / max(n_sig // c_reset, 1)
    loc = rng.uniform(0, DOMAIN, size=d)
    rv = r_vicinity
    out = np.empty((n_sig, d), dtype=np.float64)
    i = 0
    while i < n_sig:
        if rng.uniform() < p_restart:
            loc = rng.uniform(0, DOMAIN, size=d)
            if variant == "varden":
                rv = r_vicinity * float(rng.uniform(0.3, 4.0))
        m = min(c_reset, n_sig - i)
        delta = rng.uniform(-rv, rv, size=(m, d))
        out[i:i + m] = np.clip(loc[None, :] + delta, 0, DOMAIN)
        i += m
        loc = np.clip(loc + rng.uniform(-r_shift, r_shift, size=d) *
                      (rv / r_vicinity), 0, DOMAIN)
    noise = rng.uniform(0, DOMAIN, size=(n_noise, d))
    pts = np.concatenate([out, noise], axis=0)
    rng.shuffle(pts)
    return pts
