"""Port engine layer vs the JAX package and vs its own brute oracle:
cap estimation and growth equal, the tiny-caps attempt trail equal,
every port engine conformant to the port's ``brute`` on the whole
catalogue, port labels equal the reference's after canonicalisation
(contested borders excepted), the boundary errors, the device rule, and
the rule that the port imports neither ``jax`` nor ``repro``."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.engine as jengine
from repro.core.device_dbscan import GritCaps as JGritCaps
import repro_torch
import repro_torch.engine as tengine
import repro_torch.engine.adaptive as tadaptive
from repro_torch.core.dbscan import canonicalize_labels
from repro_torch.core.device_dbscan import GritCaps
from repro_torch.core.validate import (assert_labels_conformant,
                                       contested_border_mask)
from repro_torch.data.scenarios import default_scenarios, scenario_map

SCENARIOS = scenario_map()
ALL = sorted(SCENARIOS)
PORT_ENGINES = ["grit", "grit-ldf", "device", "device-kernels"]
TINY = dict(grid_cap=8, frontier_cap=8, k_cap=8, c_cap=16, m_cap=8,
            pair_cap=16, grid_block=8, pair_block=8, merge_iters=20)


def _grid_stats(x, eps, min_pts, valid=None):
    """``(num_grids, max_occ, cand_max)`` of the device census, or None."""
    c = tadaptive.device_grid_census(x, eps, min_pts, valid)
    return None if c is None else (c.num_grids, c.max_occ, c.cand_max)


@pytest.fixture(scope="module")
def brute():
    """Port brute results, one per scenario, shared by the module."""
    memo = {}

    def get(name):
        if name not in memo:
            sc = SCENARIOS[name]
            memo[name] = tengine.cluster(sc.points(), sc.eps, sc.min_pts,
                                         engine="brute", device="cpu")
        return memo[name]
    return get


# --------------------------------------------------------------------------
# registry, boundary errors, device rule
# --------------------------------------------------------------------------

def test_registry_lists_the_ported_engines():
    assert set(tengine.available_engines()) == {
        "brute", "grit", "grit-ldf", "device", "device-kernels",
        "distributed"}
    assert set(tengine.engine_descriptions()) == \
        set(tengine.available_engines())
    assert tengine.get_engine("device-kernels").name == "device-kernels"
    with pytest.raises(KeyError, match="unknown engine"):
        tengine.cluster(np.zeros((4, 2)), 1.0, 2, engine="nope",
                        device="cpu")
    with pytest.raises(ValueError, match="already registered"):
        tengine.register_engine("brute")(lambda *a, **k: None)


@pytest.mark.parametrize("engine",
                         PORT_ENGINES + ["distributed", "brute", "auto"])
def test_degenerate_inputs_rejected_uniformly(engine):
    """The same boundary ``ValueError``s as the reference, for every
    engine, before any backend (or any device lookup) runs."""
    opts = {"engine": engine}
    for fn, kw in ((tengine.cluster, dict(opts, device="cpu")),
                   (tengine.cluster, opts)):
        with pytest.raises(ValueError, match="n > 0"):
            fn(np.zeros((0, 2)), 1.0, 2, **kw)
        with pytest.raises(ValueError, match="eps must be positive"):
            fn(np.zeros((4, 2)), -1.0, 2, **kw)
        with pytest.raises(ValueError, match="min_pts must be >= 1"):
            fn(np.zeros((4, 2)), 1.0, 0, **kw)
        with pytest.raises(ValueError, match="min_pts"):
            fn(np.random.default_rng(0).uniform(0, 10, (3, 2)), 1.0, 5, **kw)
        bad = np.random.default_rng(0).uniform(0, 10, (16, 2))
        bad[3, 1] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            fn(bad, 1.0, 2, **kw)
        bad[3, 1] = np.inf
        with pytest.raises(ValueError, match="non-finite"):
            fn(bad, 1.0, 2, **kw)


@pytest.mark.parametrize("engine", ["device", "device-kernels"])
def test_device_engines_reject_identifier_overflow(engine):
    pts = np.array([[0.0, 0.0], [1e9, 1e9], [1e9, 0.0]])
    with pytest.raises(ValueError, match="device-grid identifier range"):
        tengine.cluster(pts, 1e-3, 2, engine=engine, device="cpu")
    res = tengine.cluster(pts, 1e-3, 2, engine="grit", device="cpu")
    assert (res.labels == -1).all()


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    pts = SCENARIOS["blobs-2d"].points()
    if not torch.cuda.is_available():
        for engine in ("device-kernels", "device", "auto"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tengine.cluster(pts, 2500.0, 6, engine=engine)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tengine.adaptive_device_dbscan(pts, 2500.0, 6)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tengine.resolve_auto()
    assert tengine.resolve_device("cpu") == torch.device("cpu")
    assert tengine.resolve_auto("cpu") == "grit"
    r = tengine.cluster(pts, 2500.0, 6, device="cpu")
    assert r.engine == "grit"
    # with a card present the default is the kernelized pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tengine.resolve_device(None) == torch.device("cuda")
    assert tengine.resolve_auto() == "device-kernels"
    assert tengine.resolve_auto("cuda:0") == "device-kernels"


# --------------------------------------------------------------------------
# caps: estimation, growth, attempt trail
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_estimate_caps_equal(name):
    sc = SCENARIOS[name]
    pts = sc.points()
    for kw in (dict(), dict(use_kernels=True, margin=2.0, extra_grids=5)):
        assert dataclasses.asdict(tengine.estimate_caps(
            pts, sc.eps, sc.min_pts, **kw)) == dataclasses.asdict(
                jengine.estimate_caps(pts, sc.eps, sc.min_pts, **kw))
    valid = np.arange(len(pts)) % 3 != 0
    assert dataclasses.asdict(tengine.estimate_caps(
        pts, sc.eps, sc.min_pts, point_valid=valid)) == dataclasses.asdict(
            jengine.estimate_caps(pts, sc.eps, sc.min_pts,
                                  point_valid=valid))
    assert tengine.grid_stats(pts, sc.eps) == jengine.grid_stats(pts, sc.eps)
    assert tengine.candidate_census(pts, sc.eps, sc.min_pts) == \
        jengine.candidate_census(pts, sc.eps, sc.min_pts)
    assert tengine.stencil_neighbor_bound(sc.d) == \
        jengine.stencil_neighbor_bound(sc.d)


def test_host_statistics_equal_beyond_the_int64_key_range():
    """Identifier rows too wide for a mixed-radix int64 key take the
    structured-row path and give the same numbers."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1e5, size=(400, 5))
    pts[:200] = pts[0] + rng.uniform(0, 30.0, size=(200, 5))
    eps = 0.6                       # span/side ~ 3.7e5 per dim, 5 dims
    assert tengine.grid_stats(pts, eps) == jengine.grid_stats(pts, eps)
    assert tengine.candidate_census(pts, eps, 4) == \
        jengine.candidate_census(pts, eps, 4)
    empty = np.zeros(400, bool)
    assert tengine.grid_stats(pts, eps, empty) == (1, 1)
    assert tengine.candidate_census(pts, eps, 4, empty) == 1


def _estimate_counts():
    snap = repro_torch.obs.registry().snapshot()
    return {w: snap.get(f"adaptive.estimate_caps.{w}", 0)
            for w in ("device", "host")}


@pytest.mark.parametrize("name", ALL)
def test_estimate_caps_on_a_cpu_tensor_equal(name):
    """The torch statistics, on a CPU tensor, give the reference's caps
    for both keyword sets and with a validity mask, in at most three
    host reads a call, each counted as a device estimate."""
    from repro_torch.core import sync
    sc = SCENARIOS[name]
    pts = sc.points()
    x = torch.as_tensor(pts)
    valid = np.arange(len(pts)) % 3 != 0
    wide = dict(use_kernels=True, margin=2.0, extra_grids=5)
    for kw, tkw in ((dict(), dict()), (wide, wide),
                    (dict(point_valid=valid), dict(point_valid=valid)),
                    (dict(point_valid=valid),
                     dict(point_valid=torch.as_tensor(valid)))):
        before, reads = _estimate_counts(), sync.READS["count"]
        got = tengine.estimate_caps(x, sc.eps, sc.min_pts, **tkw)
        assert sync.READS["count"] - reads <= 3
        after = _estimate_counts()
        assert (after["device"] - before["device"],
                after["host"] - before["host"]) == (1, 0)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jengine.estimate_caps(pts, sc.eps, sc.min_pts, **kw))
    assert _grid_stats(x, sc.eps, sc.min_pts) == (
        *jengine.grid_stats(pts, sc.eps),
        jengine.candidate_census(pts, sc.eps, sc.min_pts))
    none = torch.zeros(len(pts), dtype=torch.bool)
    assert _grid_stats(x, sc.eps, sc.min_pts, none) == \
        (1, 1, 1)


def _boundary_points():
    """Rows at ``mins + k * side`` and one float64 ulp either side of
    it, on every axis; ``mins`` is the first row."""
    eps, d = 7.3, 3
    side = eps / np.sqrt(d)
    mins = np.array([-12.25, 3.5, 1000.125])
    on = mins + np.arange(120)[:, None] * side
    pts = np.concatenate([on, np.nextafter(on, np.inf),
                          np.nextafter(on[1:], -np.inf)])
    rng = np.random.default_rng(3)
    mixed = np.stack([rng.permutation(pts[:, j]) for j in range(d)], 1)
    return np.concatenate([pts, mixed]), eps


def test_device_identifiers_equal_numpy_at_grid_boundaries():
    """At a grid boundary and one ulp either side, the torch identifiers
    are numpy's bit for bit (a product with the reciprocal of ``side``
    moves some of these rows by one grid), and so are the caps."""
    from repro_torch.core.grids import identifiers
    pts, eps = _boundary_points()
    want, _, _ = identifiers(pts, eps)
    got = tadaptive.device_identifiers(torch.as_tensor(pts), eps,
                                       torch.ones(len(pts), dtype=torch.bool))
    np.testing.assert_array_equal(got.to(torch.int64).numpy(), want)
    valid = np.arange(len(pts)) % 4 != 1
    want_v, _, _ = identifiers(pts[valid], eps)
    got_v = tadaptive.device_identifiers(torch.as_tensor(pts), eps,
                                       torch.as_tensor(valid))
    np.testing.assert_array_equal(got_v.to(torch.int64).numpy()[valid],
                                  want_v)
    assert (got_v.numpy()[~valid] == 0).all()
    for kw in (dict(), dict(point_valid=valid)):
        assert dataclasses.asdict(tengine.estimate_caps(
            torch.as_tensor(pts), eps, 4, **kw)) == dataclasses.asdict(
                jengine.estimate_caps(pts, eps, 4, **kw))


def test_a_float64_fit_estimates_on_the_callers_values():
    """A float64 array whose values float32 cannot hold: the fit's first
    caps are the estimate of the float64 array, not of the float32 copy
    the pipeline runs on (which puts 20 rows in another grid here)."""
    pts = np.concatenate([[[0.0]], np.full((20, 1), 999.99999999),
                          np.full((20, 1), 1000.5), [[2000.0]]])
    want = tengine.estimate_caps(pts, 1.0, 3)
    assert dataclasses.asdict(want) != dataclasses.asdict(
        tengine.estimate_caps(pts.astype(np.float32), 1.0, 3))
    _, attempts = tengine.adaptive_device_dbscan(pts, 1.0, 3, device="cpu")
    assert attempts[0]["caps"] == dataclasses.asdict(want)
    assert attempts[0]["caps"] == dataclasses.asdict(
        jengine.estimate_caps(pts, 1.0, 3))


def test_a_key_space_beyond_int64_takes_the_host_statistics():
    """Identifier rows too wide for an int64 key: the estimate runs the
    host functions, counts ``adaptive.estimate_caps.host``, and gives
    the reference's caps in at most three host reads."""
    from repro_torch.core import sync
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1e5, size=(400, 5))
    pts[:200] = pts[0] + rng.uniform(0, 30.0, size=(200, 5))
    eps = 0.6                       # span/side ~ 3.7e5 per dim, 5 dims
    assert _grid_stats(torch.as_tensor(pts), eps, 4) is None
    valid = np.arange(len(pts)) % 3 != 0
    for x in (pts, torch.as_tensor(pts)):
        for kw in (dict(), dict(point_valid=valid)):
            before, reads = _estimate_counts(), sync.READS["count"]
            got = tengine.estimate_caps(x, eps, 4, **kw)
            assert sync.READS["count"] - reads <= 3
            after = _estimate_counts()
            assert (after["device"] - before["device"],
                    after["host"] - before["host"]) == (0, 1)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jengine.estimate_caps(pts, eps, 4, **kw))


@pytest.mark.parametrize("flags", [("grid",), ("frontier",), ("neighbors",),
                                   ("candidates",), ("core_set",),
                                   ("pairs",), ("grid", "pairs", "core_set")])
def test_grow_caps_equal(flags):
    pts = np.random.default_rng(0).uniform(0, 1e5, (64, 2))
    jc = jengine.estimate_caps(pts, 3000.0, 5)
    tc = tengine.estimate_caps(pts, 3000.0, 5)
    for growth in (2.0, 3.0):
        try:
            want = dataclasses.asdict(jengine.grow_caps(
                jc, flags, n=10_000, d=2, growth=growth))
        except jengine.CapOverflowError:
            # already at its provable clamp (k_cap at the 2-D stencil
            # bound): the port refuses to grow it as well
            with pytest.raises(tengine.CapOverflowError):
                tengine.grow_caps(tc, flags, n=10_000, d=2, growth=growth)
            continue
        assert dataclasses.asdict(tengine.grow_caps(
            tc, flags, n=10_000, d=2, growth=growth)) == want


def test_grow_caps_raises_at_clamp():
    caps = GritCaps(**dict(TINY, c_cap=64))
    with pytest.raises(tengine.CapOverflowError):
        tengine.grow_caps(caps, ("candidates",), n=64, d=2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_tiny_caps_attempt_trail_equal(use_kernels, brute):
    """From the same under-provisioned caps both packages walk the same
    trail of (caps, overflowing flags) and end exact."""
    import jax.numpy as jnp
    sc = SCENARIOS["duplicates-2d"]
    pts = sc.points()
    ref, ref_attempts = jengine.adaptive_device_dbscan(
        jnp.asarray(pts, jnp.float32), sc.eps, sc.min_pts,
        JGritCaps(**TINY), growth=3.0, use_kernels=use_kernels)
    got, attempts = tengine.adaptive_device_dbscan(
        pts, sc.eps, sc.min_pts, GritCaps(**TINY), growth=3.0,
        use_kernels=use_kernels, device="cpu")
    assert attempts == ref_attempts
    assert len(attempts) > 1 and attempts[-1]["overflow"] == ()
    assert all(a["caps"]["use_kernels"] == use_kernels for a in attempts)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.core.numpy(), np.asarray(ref.core))
    assert_labels_conformant(pts, sc.eps, sc.min_pts,
                             brute("duplicates-2d").labels,
                             got.labels.numpy())
    with pytest.raises(tengine.CapOverflowError, match="overflowing"):
        tengine.adaptive_device_dbscan(pts, sc.eps, sc.min_pts,
                                       GritCaps(**TINY), max_retries=0,
                                       device="cpu")


# --------------------------------------------------------------------------
# conformance: port engines vs port brute, port vs reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", PORT_ENGINES)
@pytest.mark.parametrize("name", ALL)
def test_port_engine_conformance(name, engine, brute):
    sc = SCENARIOS[name]
    pts = sc.points()
    ref = brute(name)
    res = tengine.cluster(pts, sc.eps, sc.min_pts, engine=engine,
                          device="cpu")
    assert res.engine == engine and res.overflow == ()
    assert res.labels.dtype == np.int64 and res.index is None
    assert_labels_conformant(pts, sc.eps, sc.min_pts, ref.labels,
                             res.labels, core=ref.core)
    np.testing.assert_array_equal(res.core, ref.core)
    np.testing.assert_array_equal(res.core_idx, np.flatnonzero(ref.core))
    if engine.startswith("device"):
        assert res.attempts and res.attempts[-1]["overflow"] == ()
        assert res.stats["device"] == "cpu"
        assert res.attempts[-1]["caps"]["use_kernels"] == \
            (engine == "device-kernels")


@pytest.mark.parametrize("name", ALL)
def test_port_labels_equal_reference_labels(name, brute):
    """``cluster(engine="device-kernels", device="cpu")`` against the JAX
    package's exact labels, label for label after canonicalisation,
    contested borders excepted (as ``tests/test_conformance.py`` does).
    The reference side is its host engine on every scenario and its own
    ``device-kernels`` engine on the quick subset."""
    sc = SCENARIOS[name]
    pts = sc.points()
    got = tengine.cluster(pts, sc.eps, sc.min_pts, engine="device-kernels",
                          device="cpu")
    ref_engines = ["grit"] + (["device-kernels"] if sc.has("quick") else [])
    for ref_engine in ref_engines:
        ref = jengine.cluster(pts, sc.eps, sc.min_pts, engine=ref_engine)
        np.testing.assert_array_equal(got.core, ref.core)
        assert got.n_clusters == ref.n_clusters
        assert got.noise_count == ref.noise_count
        keep = ~contested_border_mask(pts, sc.eps, ref.core, ref.labels)
        np.testing.assert_array_equal(
            canonicalize_labels(got.labels[keep]),
            canonicalize_labels(ref.labels[keep]))
        if ref_engine == "device-kernels":
            assert got.attempts == ref.attempts
            np.testing.assert_array_equal(
                canonicalize_labels(got.labels),
                canonicalize_labels(ref.labels))


def test_brute_engine_equals_reference_brute():
    for name in ("blobs-2d", "duplicates-2d", "eps-chain-2d"):
        sc = SCENARIOS[name]
        pts = sc.points()
        got = tengine.cluster(pts, sc.eps, sc.min_pts, engine="brute",
                              device="cpu")
        ref = jengine.cluster(pts, sc.eps, sc.min_pts, engine="brute")
        np.testing.assert_array_equal(got.labels, ref.labels)
        np.testing.assert_array_equal(got.core, ref.core)


# --------------------------------------------------------------------------
# the port stands alone
# --------------------------------------------------------------------------

ROOT = pathlib.Path(repro_torch.__file__).resolve().parent
REPO = ROOT.parents[1]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"]
                         + sorted(REPO.glob("examples/torch_*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots


def test_fresh_process_imports_no_jax_and_no_repro():
    mods = sorted(str(p.relative_to(ROOT.parent).with_suffix(""))
                  .replace(os.sep, ".").removesuffix(".__init__")
                  for p in ROOT.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import numpy as np\n"
        "from repro_torch.engine import cluster\n"
        "r = cluster(np.random.default_rng(0).uniform(0, 100, (64, 2)), "
        "9.0, 3, engine='device-kernels', device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('CLEAN', r.n_clusters)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CLEAN" in out.stdout


def test_every_catalogue_scenario_is_covered():
    assert len(default_scenarios()) == len(ALL) == 19
