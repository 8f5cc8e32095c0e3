"""The port's observability plane (``repro_torch.obs``), twin of
``tests/test_obs.py``, and its parity with the reference's.

Pins the invariants the plane is built on, on the port:

* **Disabled tracer is free** -- ``span()`` returns the shared no-op
  object (zero events, zero allocations), and ``src/`` (both packages)
  is clean under every ``repro.analysis`` rule, the port's span close
  carrying its one justified ``hot-path-sync`` pragma.
* **Chrome trace / JSONL export round-trips**, and interval nesting
  reconstructs the order the spans were recorded in.
* **The counter registry loses nothing under the serve driver**
  (``ClusterServer(device="cpu")``), with tracing on or off.
* **Provenance stamps are complete** -- ``bench_meta()`` carries the
  torch keys and the card's name and power limit.
* **Cross-package parity** -- the same fit, insert, delete and server
  steps through the reference (``engine="grit"``) and the port, tracing
  on in both: the same span names, and equal counters wherever a
  counter does not depend on how a package lays out its work.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.obs import view as obs_view
from repro_torch.obs.export import load_trace, write_chrome_trace, write_jsonl
from repro_torch.obs.metrics import MetricsRegistry


@pytest.fixture
def tracer():
    """Fresh enabled port tracer, restored to prior state afterwards."""
    was = obs.enabled()
    t = obs.enable(clear=True)
    yield t
    if not was:
        obs.disable()


# ---------------------------------------------------------------------------
# disabled-tracer invariant
# ---------------------------------------------------------------------------

def test_disabled_tracer_is_shared_noop():
    was = obs.enabled()
    obs.disable()
    try:
        s1 = obs.span("anything", n=3)
        s2 = obs.span("else")
        assert s1 is s2 is obs.NOOP_SPAN
        # reentrant, chainable, recordless
        with obs.span("outer") as sp:
            assert sp.set(k=1) is sp
            assert sp.sync(torch.zeros(2)) is sp
            with obs.span("inner"):
                pass
        assert obs.get_tracer() is None
        assert not obs.enabled()
    finally:
        if was:
            obs.enable()


def test_src_clean_under_every_rule_and_span_close_has_its_pragma():
    """The port is linted with the reference: with the port's
    ``ClusterServer.step`` a second hot-path root, ``src`` must still be
    clean, and the port tracer's one wait at span close carries its
    justified pragma."""
    from repro.analysis import analyze_paths

    pkg = os.path.dirname(obs.__file__)
    src = os.path.dirname(os.path.dirname(pkg))
    report = analyze_paths([src])
    assert not report.active, [(v.rule, v.path) for v in report.active]
    with open(os.path.join(pkg, "trace.py")) as f:
        lines = f.read().splitlines()
    waits = [ln for ln in lines if "synchronize()" in ln
             and not ln.lstrip().startswith("#")]
    assert len(waits) == 1
    assert "grit-lint: disable=hot-path-sync --" in waits[0]


def test_span_waits_only_for_cuda_tensors(tracer):
    """Registered CPU tensors and plain values need no wait: the close
    finds no CUDA device to wait for, and the event still records."""
    from repro_torch.obs.trace import _cuda_devices

    vals = [torch.ones(3), [np.zeros(2), {"k": torch.zeros(1)}], 7]
    assert _cuda_devices(vals) == []
    with obs.span("stage") as sp:
        sp.sync(*vals)
    (ev,) = tracer.snapshot_events()
    assert ev["name"] == "stage" and ev["dur"] >= 0.0


@pytest.mark.gpu
def test_span_close_waits_for_registered_cuda_work(tracer):
    """On a CUDA device the span close waits for the registered tensor's
    work (skipped where there is none; ``chip_smoke.py`` phase
    ``server`` traces the served stream on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the span close waits on a CUDA "
                    "event")
    x = torch.randn(2048, 2048, device="cuda")
    with obs.span("matmul") as sp:
        y = x @ x
        sp.sync(y)
    assert torch.cuda.current_stream().query()
    (ev,) = tracer.snapshot_events()
    assert ev["name"] == "matmul"


# ---------------------------------------------------------------------------
# spans + chrome export round-trip
# ---------------------------------------------------------------------------

def _record_nested(tracer):
    with obs.span("fit", n=100):
        with obs.span("pack"):
            pass
        with obs.span("cluster"):
            with obs.span("kernel", bucket=256):
                pass
        with obs.span("unpack"):
            pass
    return tracer.snapshot_events()


def test_span_events_record_entry_exit_order(tracer):
    events = _record_nested(tracer)
    # complete events append at *exit*: children precede the parent
    assert [e["name"] for e in events] == [
        "pack", "kernel", "cluster", "unpack", "fit"]
    by = {e["name"]: e for e in events}
    assert by["fit"]["depth"] == 0
    assert by["pack"]["depth"] == by["cluster"]["depth"] == 1
    assert by["kernel"]["depth"] == 2
    assert by["fit"]["args"] == {"n": 100}
    for child, parent in [("pack", "fit"), ("cluster", "fit"),
                          ("kernel", "cluster")]:
        c, p = by[child], by[parent]
        assert c["ts"] >= p["ts"]
        assert c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 1e-6


def test_chrome_trace_roundtrip_and_nesting(tracer, tmp_path):
    events = _record_nested(tracer)
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), events,
                       metrics={"k.count": 3}, meta={"git_rev": "abc"})
    doc = json.loads(path.read_text())
    assert {"traceEvents", "displayTimeUnit", "otherData"} <= set(doc)
    assert all(e["ph"] == "X" and e["dur"] >= 0.0
               for e in doc["traceEvents"])
    got, metrics, meta = load_trace(str(path))
    assert [e["name"] for e in got] == [e["name"] for e in events]
    assert metrics == {"k.count": 3} and meta == {"git_rev": "abc"}
    parents = {e["name"]: e["parent"] for e in obs_view._nest(got)}
    assert parents == {"fit": None, "pack": "fit", "cluster": "fit",
                       "kernel": "cluster", "unpack": "fit"}


def test_jsonl_roundtrip(tracer, tmp_path):
    events = _record_nested(tracer)
    path = tmp_path / "trace.jsonl"
    write_jsonl(str(path), events, metrics={"c": 1},
                meta={"git_rev": "abc"})
    got, metrics, meta = load_trace(str(path))
    assert [e["name"] for e in got] == [e["name"] for e in events]
    assert metrics == {"c": 1} and meta["git_rev"] == "abc"


def test_attribution_and_view_cli(tracer, tmp_path, capsys):
    events = _record_nested(tracer)
    att = obs_view.attribution(events, root="fit")
    assert set(att["children"]) == {"pack", "cluster", "unpack"}
    assert 0.0 < att["coverage"] <= 1.0 + 1e-9
    path = tmp_path / "trace.json"
    write_chrome_trace(
        str(path), events,
        metrics={"adaptive.retries": 2, "kernels.build.compiles": 2},
        meta={"torch": "2.x", "device_kind": "H100",
              "power_limit": "H100, 700.00 W"})
    assert obs_view.main([str(path), "--root", "fit"]) == 0
    out = capsys.readouterr().out
    assert "attribution of 'fit'" in out
    assert "adaptive.retries" in out
    assert "kernel build counters:" in out
    assert "torch=2.x" in out and "power_limit=H100, 700.00 W" in out


def test_span_error_path_still_records(tracer):
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    (ev,) = tracer.snapshot_events()
    assert ev["name"] == "boom" and ev["args"]["error"] is True


def test_export_chrome_writes_the_live_tracer(tracer, tmp_path):
    _record_nested(tracer)
    path = tmp_path / "live.json"
    assert obs.export_chrome(str(path), reg=MetricsRegistry(), meta=False)
    got, _, _ = load_trace(str(path))
    assert {e["name"] for e in got} == {"fit", "pack", "cluster", "kernel",
                                        "unpack"}


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def test_registry_counter_gauge_histogram():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(0.25)
    h = reg.histogram("h")
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0]
    for v in vals:
        h.observe(v)
    assert reg.counter("c").value == 5
    assert reg.gauge("g").value == 0.25
    assert h.count == len(vals) and h.total == sum(vals)
    for q in (50, 95, 99):
        assert h.percentile(q) == pytest.approx(np.percentile(vals, q))
    snap = reg.snapshot()
    assert snap["c"] == 5
    with pytest.raises(TypeError, match="is a Counter"):
        reg.gauge("c")
    reg.reset()
    assert reg.counter("c").value == 0


def test_build_hooks_count_compiles_and_loads(monkeypatch):
    """``install_build_hooks`` turns ``kernels/build.py``'s compile and
    load events into ``kernels.build.*`` (the reference's jit-compile
    counters' place)."""
    from repro_torch.kernels import build
    from repro_torch.obs import metrics

    monkeypatch.setattr(build, "_LISTENERS", [])
    monkeypatch.setattr(metrics, "_BUILD_HOOKS", {"installed": False})
    before = metrics.build_counts()
    n_sec = metrics.registry().histogram("kernels.build.seconds").count
    assert metrics.install_build_hooks() and metrics.build_hooks_installed()
    assert metrics.install_build_hooks()          # idempotent
    assert len(build._LISTENERS) == 1
    build._notify("compile", name="pairwise", seconds=1.5)
    build._notify("load", name="pairwise")
    after = metrics.build_counts()
    assert after.get("kernels.build.compiles", 0) \
        == before.get("kernels.build.compiles", 0) + 1
    assert after.get("kernels.build.loads", 0) \
        == before.get("kernels.build.loads", 0) + 1
    assert metrics.registry().histogram("kernels.build.seconds").count \
        == n_sec + 1


def test_bench_meta_provenance_keys():
    meta = obs.bench_meta()
    for k in ("timestamp", "python", "platform", "git_rev", "torch",
              "cuda", "backend", "device_kind", "device_count",
              "power_limit"):
        assert k in meta, k
    assert meta["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert meta["backend"] == "cpu" and meta["device_count"] == 0
    json.dumps(meta)


# ---------------------------------------------------------------------------
# serve driver: no lost increments under the double-buffered step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_index():
    from repro_torch.data.scenarios import get_serving_scenario
    from repro_torch.engine import cluster

    ss = get_serving_scenario("query-heavy-3d")
    res = cluster(ss.fit_points(), ss.base.eps, ss.base.min_pts,
                  engine="grit", device="cpu", return_index=True)
    return ss, res.index


def test_serve_counters_account_every_request(served_index):
    from repro_torch.serve import ClusterServer

    ss, idx = served_index
    sizes = [7, 31, 2, 18, 25, 13, 9, 4]
    q = ss.query_batch(seed=3, n=int(sum(sizes)))
    srv = ClusterServer(idx, slots=3, mode="host", device="cpu")
    off = 0
    for m in sizes:
        srv.submit(q[off:off + m])
        off += m
    done = srv.run()
    reg = srv.metrics
    assert reg.counter("serve.requests").value == len(sizes) == len(done)
    assert reg.counter("serve.queries").value == sum(sizes)
    assert reg.counter("serve.steps").value == len(srv.step_log)
    assert reg.histogram("serve.latency_ms").count == len(sizes)
    qw = reg.histogram("serve.queue_wait_ms")
    assert qw.count == len(sizes)
    assert all(s["queue_wait_ms"] >= 0.0 for s in srv.step_log)

    s = srv.summary()
    assert s["requests"] == len(sizes) and s["queries"] == sum(sizes)
    lat = reg.histogram("serve.latency_ms")
    assert s["latency_ms_p50"] == pytest.approx(lat.percentile(50))
    assert s["latency_ms_p99"] == pytest.approx(lat.percentile(99))
    assert s["queue_wait_ms_p50"] == pytest.approx(qw.percentile(50))
    assert s["latency_ms_p50"] <= s["latency_ms_p95"] \
        <= s["latency_ms_p99"]


def test_serve_counters_survive_tracing_toggle(served_index):
    """Tracing on must not change the request/query accounting, and a
    server run with tracing off records nothing."""
    from repro_torch.serve import ClusterServer

    ss, idx = served_index
    was = obs.enabled()
    obs.enable(clear=True)
    try:
        srv = ClusterServer(idx, slots=2, mode="host", device="cpu")
        for seed in range(5):
            srv.submit(ss.query_batch(seed=seed, n=6))
        srv.run()
        assert srv.metrics.counter("serve.requests").value == 5
        assert srv.metrics.counter("serve.queries").value == 30
        names = {e["name"] for e in obs.get_tracer().snapshot_events()}
        assert {"serve.step", "serve.step.mutate", "serve.step.dispatch",
                "serve.step.admit_next", "serve.step.resolve"} <= names
        frozen = obs.disable()
        n_events = len(frozen.snapshot_events())
        srv.submit(ss.query_batch(seed=9, n=6))
        srv.run()
        assert len(frozen.snapshot_events()) == n_events
        assert srv.metrics.counter("serve.requests").value == 6
    finally:
        if was:
            obs.enable()
        else:
            obs.disable()


def test_delta_spans_wrap_every_stage_on_a_resident_plane(served_index):
    """With a resident state (on the CPU) each mutation records its five
    stage spans under the reference's names, and the flat-gather and
    upload counters move."""
    from repro_torch.index import GritIndex

    ss, idx = served_index
    ix = GritIndex.restore(idx.snapshot())
    ix.ensure_device_state("cpu")
    reg = obs.registry()
    before = reg.snapshot()
    was = obs.enabled()
    t = obs.enable(clear=True)
    try:
        ix.insert(ss.insert_batches(seed=1, steps=1)[0])
        ix.delete(ix.arrival_live()[:20])
        names = [e["name"] for e in t.snapshot_events()]
    finally:
        if not was:
            obs.disable()
    want = [f"delta.insert.{s}" for s in
            ("identifiers", "splice", "cores", "merge_repair", "reconcile")]
    want += [f"delta.delete.{s}" for s in
             ("tombstone", "demotions", "merge_repair", "components",
              "compaction")]
    assert names == want
    after = reg.snapshot()

    def moved(k):
        return after.get(k, 0) - before.get(k, 0)

    assert moved("delta.insert.count") == 1
    assert moved("delta.delete.count") == 1
    assert moved("device_state.uploads.rows") == 1
    assert moved("device_state.uploads.small") == 2
    assert moved("device_state.donations") >= 1


# ---------------------------------------------------------------------------
# cross-package parity
# ---------------------------------------------------------------------------

def _int_delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if isinstance(v, int) and v != before.get(k, 0)}


def _pkg_run(pkg, ss):
    """Fit with the index, attach the resident state, one insert, one
    delete and three server steps through ``pkg`` (``repro`` or
    ``repro_torch``), with tracing on.  Returns (span names, default
    registry counter deltas, server registry snapshot)."""
    import importlib

    pobs = importlib.import_module(f"{pkg}.obs")
    engine = importlib.import_module(f"{pkg}.engine")
    serve = importlib.import_module(f"{pkg}.serve")
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    pts = ss.fit_points()
    was = pobs.enabled()
    before = pobs.registry().snapshot()
    t = pobs.enable(clear=True)
    try:
        res = engine.cluster(pts, ss.base.eps, ss.base.min_pts,
                             engine="grit", return_index=True, **kw)
        idx = res.index
        srv = serve.ClusterServer(idx, slots=2, mode="device",
                                  device_state=True, **kw)
        srv.submit_insert(ss.insert_batches(seed=0, steps=1)[0])
        srv.submit_delete(np.arange(0, 60, 3))
        for seed in range(4):
            srv.submit(ss.query_batch(seed=seed, n=24))
        srv.run()
        names = {e["name"] for e in t.snapshot_events()}
    finally:
        if not was:
            pobs.disable()
    deltas = _int_delta(before, pobs.registry().snapshot())
    return names, deltas, srv.metrics.snapshot()


# counters whose values follow each package's own layout of the work:
# the reference pads each flat gather to a power-of-two bucket, the port
# ships the exact element count (``bucket_elems``), and the reference's
# jit-compile counters have the kernel-build counters as their twin
LAYOUT_COUNTERS = ("kernels.flat.predict.bucket_elems",
                   "kernels.flat.res.bucket_elems")


def test_span_names_and_counters_equal_across_packages():
    """The reference (``engine="grit"``) and the port on the CPU, tracing
    on in both, over the same fit, insert, delete and server steps:

    * the span names are the same set;
    * every counter is equal -- ``engine.cluster.*``, ``adaptive.*``,
      ``delta.*``, ``device_state.uploads.*`` / ``donations``, the flat
      gathers' dispatches and valid elements, the server's ``serve.*``
      -- except ``kernels.flat.*.bucket_elems``: the reference ships
      each flat gather padded to a power-of-two bucket, the port ships
      its exact element count, so only those differ (and are checked to
      be, for the port, equal to ``elems``);
    * ``jax.events.*`` (the reference's jit-compile bridge) have no
      twin here: the port's one-off costs are ``kernels.build.*``,
      which a CPU run never moves.

    The port chunks its fit sweeps by a memory budget, but no counter
    counts sweeps, so nothing else may differ.
    """
    from repro.data.scenarios import get_serving_scenario as jget
    from repro_torch.data.scenarios import get_serving_scenario

    r_names, r_ctr, r_srv = _pkg_run("repro", jget("query-heavy-3d"))
    p_names, p_ctr, p_srv = _pkg_run(
        "repro_torch", get_serving_scenario("query-heavy-3d"))
    assert r_names == p_names
    assert {"engine.cluster", "engine.attach_index", "serve.step",
            "serve.step.mutate", "serve.step.dispatch",
            "serve.step.admit_next", "serve.step.resolve",
            "delta.insert.splice", "delta.delete.tombstone"} <= p_names

    def comparable(c):
        return {k: v for k, v in c.items()
                if k not in LAYOUT_COUNTERS
                and not k.startswith("jax.events.")}

    assert comparable(r_ctr) == comparable(p_ctr)
    assert p_ctr["engine.cluster.grit"] == 1
    assert p_ctr["device_state.uploads.rows"] >= 2
    for stage in ("predict", "res"):
        k = f"kernels.flat.{stage}"
        if f"{k}.elems" in p_ctr:
            assert p_ctr[f"{k}.bucket_elems"] == p_ctr[f"{k}.elems"]
    serve_r = {k: v for k, v in r_srv.items() if isinstance(v, int)}
    serve_p = {k: v for k, v in p_srv.items() if isinstance(v, int)}
    assert serve_r == serve_p
    assert serve_p["serve.requests"] == 6
