"""The fit's cap estimate on the card (marker ``gpu``; skipped where
there is no CUDA device).  This file imports no JAX, so it runs on a
machine with a card: ``python -m pytest -q -m gpu
tests/test_torch_estimate_caps_card.py``.

* On 10^5 seed-spreader points (the benchmark cells' generator, d = 3
  and 5, eps 5,000, MinPts 100) the torch statistics on the card equal
  those on a CPU tensor and the host functions ``grid_stats`` /
  ``candidate_census``, and so do the caps.
* At grid boundaries and one float64 ulp either side, the card's
  identifiers equal numpy's bit for bit (CUDA's division by a CPU
  scalar multiplies by its reciprocal, which moves some of these rows).
* A device fit's ``adaptive.estimate_caps`` span names the card in
  ``where``, and counts one ``adaptive.estimate_caps.device``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.grids import identifiers
from repro_torch.data.seed_spreader import seed_spreader
from repro_torch.engine import adaptive, cluster

EPS, MIN_PTS = 5000.0, 100


def _grid_stats(x, eps, min_pts, valid=None):
    """``(num_grids, max_occ, cand_max)`` of the device census, or None."""
    c = adaptive.device_grid_census(x, eps, min_pts, valid)
    return None if c is None else (c.num_grids, c.max_occ, c.cand_max)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the estimate runs on the device "
                    "of its tensor")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant,d", [("varden", 3), ("simden", 5)])
def test_card_statistics_equal_the_cpu_and_host_ones(card, variant, d):
    pts = np.rint(seed_spreader(10 ** 5, d, variant=variant, seed=0))
    x = torch.as_tensor(pts.astype(np.float32))
    want = (*adaptive.grid_stats(x.numpy(), EPS),
            adaptive.candidate_census(x.numpy(), EPS, MIN_PTS))
    assert _grid_stats(x, EPS, MIN_PTS) == want
    assert _grid_stats(x.to(card), EPS, MIN_PTS) == want
    valid = torch.arange(len(pts)) % 3 != 0
    want_v = (*adaptive.grid_stats(x.numpy(), EPS, valid.numpy()),
              adaptive.candidate_census(x.numpy(), EPS, MIN_PTS,
                                        valid.numpy()))
    assert _grid_stats(x.to(card), EPS, MIN_PTS,
                                      valid.to(card)) == want_v
    caps = dataclasses.asdict(adaptive.estimate_caps(x, EPS, MIN_PTS))
    assert dataclasses.asdict(adaptive.estimate_caps(
        x.to(card), EPS, MIN_PTS)) == caps
    # a numpy array goes to the card
    assert dataclasses.asdict(adaptive.estimate_caps(
        pts, EPS, MIN_PTS)) == caps


@pytest.mark.gpu
def test_card_identifiers_equal_numpy_at_grid_boundaries(card):
    eps, d = 7.3, 3
    side = eps / np.sqrt(d)
    mins = np.array([-12.25, 3.5, 1000.125])
    on = mins + np.arange(120)[:, None] * side
    pts = np.concatenate([on, np.nextafter(on, np.inf),
                          np.nextafter(on[1:], -np.inf)])
    want, _, _ = identifiers(pts, eps)
    x = torch.as_tensor(pts, device=card)
    got = adaptive.device_identifiers(
        x, eps, torch.ones(len(pts), dtype=torch.bool, device=card))
    np.testing.assert_array_equal(got.to(torch.int64).cpu().numpy(), want)
    valid = torch.arange(len(pts), device=card) % 4 != 1
    got_v = adaptive.device_identifiers(x, eps, valid)
    keep = valid.cpu().numpy()
    want_v, _, _ = identifiers(pts[keep], eps)
    np.testing.assert_array_equal(
        got_v.to(torch.int64).cpu().numpy()[keep], want_v)


@pytest.mark.gpu
def test_a_device_fit_estimates_on_the_card(card):
    pts = np.random.default_rng(0).uniform(0.0, 10.0, (2000, 3))
    was = obs.enabled()
    tracer = obs.enable(clear=True)
    try:
        before = obs.registry().snapshot()
        res = cluster(pts.astype(np.float32), 1.5, 4, engine="device",
                      device=card)
        after = obs.registry().snapshot()
        (est,) = [e for e in tracer.snapshot_events()
                  if e["name"] == "adaptive.estimate_caps"]
    finally:
        if not was:
            obs.disable()
    assert res.attempts[-1]["overflow"] == ()
    assert est["args"]["where"] == str(torch.empty(0, device=card).device)
    for where, moved in (("device", 1), ("host", 0)):
        key = f"adaptive.estimate_caps.{where}"
        assert after.get(key, 0) - before.get(key, 0) == moved
