"""The spans inside a fit of the device pipeline (``repro_torch.obs``).

A traced ``cluster(..., engine="device-kernels")`` records
``engine.cluster`` > ``engine.cluster.prepare``, ``adaptive.upload``,
``adaptive.estimate_caps`` (> ``adaptive.census``), one
``adaptive.attempt`` per try (each >
the seven ``device_dbscan.<stage>`` spans) and
``engine.cluster.finish``.  Pinned on the CPU:

* with tracing off a fit records nothing: no span, no CUDA event, no
  profiler range;
* with tracing on, under ``torch.profiler``, every span is also a
  ``user_annotation`` range of the profiler's trace, nested as the
  tracer nests it;
* the direct children of ``engine.cluster`` cover it, and each stage's
  ``device_ms`` lies inside its attempt;
* :class:`repro_torch.obs.Stages` reads CUDA events without a wait,
  and an error inside the pipeline leaves no span open;
* on the card (marker ``gpu``), a fit's stages carry the device time of
  their CUDA events.

The points (400 uniform in [0, 10]^3, eps 1.5, MinPts 4) make the
estimated ``k_cap`` overflow once, so a fit takes two attempts.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import sync
from repro_torch.engine import cluster
from repro_torch.obs import view as obs_view

STAGES = tuple(f"device_dbscan.{s}" for s in sync.STAGE_ORDER)
CHILDREN = ("engine.cluster.prepare", "adaptive.upload",
            "adaptive.estimate_caps", "adaptive.attempt",
            "engine.cluster.finish")
#: inside ``adaptive.estimate_caps``, where some grid is below MinPts
CENSUS = "adaptive.census"
FIT_SPANS = {"engine.cluster", *CHILDREN, CENSUS, *STAGES}
EPS, MIN_PTS = 1.5, 4


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    return rng.uniform(0.0, 10.0, (400, 3)).astype(np.float32)


def fit(points):
    return cluster(points, EPS, MIN_PTS, engine="device-kernels",
                   device="cpu")


@pytest.fixture
def tracer():
    was = obs.enabled()
    t = obs.enable(clear=True)
    yield t
    if not was:
        obs.disable()


@pytest.fixture
def off():
    was = obs.enabled()
    obs.disable()
    yield
    if was:
        obs.enable()


def profiled_fit(points, tmp_path):
    """One fit under a CPU profiler: (result, the trace's
    ``user_annotation`` events of the fit's span names)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = fit(points)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e.get("name") in FIT_SPANS]
    return res, ranges


def tree(events):
    """(name, parent name) of each event, in start order, by interval
    nesting."""
    nested = obs_view._nest([dict(e, ts=float(e["ts"]),
                                  dur=float(e["dur"]), pid=0, tid=0)
                             for e in events])
    return [(e["name"], e["parent"]) for e in nested]


def test_tracing_off_a_fit_records_nothing(points, off, monkeypatch,
                                           tmp_path):
    made = []
    real = torch.cuda.Event

    def counted(*a, **k):
        made.append(1)
        return real(*a, **k)
    monkeypatch.setattr(torch.cuda, "Event", counted)
    assert obs.span("engine.cluster") is obs.NOOP_SPAN
    res, ranges = profiled_fit(points, tmp_path)
    assert len(res.attempts) == 2
    assert made == []
    assert ranges == []
    assert obs.get_tracer() is None


def test_fit_spans_lie_in_the_profiler_trace_nested_as_recorded(
        points, tracer, tmp_path):
    res, ranges = profiled_fit(points, tmp_path)
    assert [a["overflow"] for a in res.attempts] == [("neighbors",), ()]
    events = tracer.snapshot_events()
    assert {e["name"] for e in events} == FIT_SPANS
    got = tree(ranges)
    assert got == tree(events)
    want = ([("engine.cluster", None)]
            + [(c, "engine.cluster") for c in CHILDREN[:3]]
            + [(CENSUS, "adaptive.estimate_caps")])
    for _ in range(2):
        want += [("adaptive.attempt", "engine.cluster")]
        want += [(s, "adaptive.attempt") for s in STAGES]
    want += [("engine.cluster.finish", "engine.cluster")]
    assert got == want
    attempts = sorted((e for e in events if e["name"] == "adaptive.attempt"),
                      key=lambda e: e["ts"])
    assert [(a["args"]["index"], a["args"]["kept"]) for a in attempts] == \
        [(0, False), (1, True)]
    assert attempts[0]["args"]["overflow"] == ["neighbors"]
    assert attempts[1]["args"]["overflow"] == []
    (est,) = [e for e in events if e["name"] == "adaptive.estimate_caps"]
    # the padded input, estimated on the tensor the fit uploaded
    assert est["args"] == {"n": 512, "d": 3, "where": "cpu"}
    (census,) = [e for e in events if e["name"] == CENSUS]
    assert census["args"]["route"] == "stencil"
    assert census["args"]["probes"] == census["args"]["small"] * 117


def test_direct_children_cover_the_fit_and_stages_lie_in_attempts(
        points, tracer):
    fit(points)
    events = tracer.snapshot_events()
    att = obs_view.attribution(events, root="engine.cluster")
    assert set(att["children"]) == set(CHILDREN)
    assert att["coverage"] >= 0.9, att
    attempts = [e for e in events if e["name"] == "adaptive.attempt"]
    stages = [e for e in events if e["name"] in STAGES]
    assert len(stages) == 7 * len(attempts) == 14
    for s in stages:
        (a,) = [a for a in attempts
                if a["ts"] <= s["ts"] and s["ts"] + s["dur"]
                <= a["ts"] + a["dur"]]
        assert 0.0 <= s["args"]["device_ms"] <= a["dur"] * 1e-3
        # on the CPU a stage's device time is its host interval
        assert s["args"]["device_ms"] == pytest.approx(s["dur"] * 1e-3)


def test_an_error_inside_the_pipeline_leaves_no_span_open(
        points, tracer, monkeypatch):
    from repro_torch.core import device_dbscan as dd

    def broken(*a, **k):
        raise RuntimeError("merge failed")
    monkeypatch.setattr(dd, "fast_merging_batch", broken)
    with pytest.raises(RuntimeError, match="merge failed"):
        fit(points)
    monkeypatch.undo()
    events = tracer.snapshot_events()
    (merge,) = [e for e in events if e["name"] == "device_dbscan.merge"]
    assert merge["args"]["error"] is True
    assert "device_dbscan.components" not in {e["name"] for e in events}
    tracer.clear()
    fit(points)
    (top,) = [e for e in tracer.snapshot_events()
              if e["name"] == "engine.cluster"]
    assert top["depth"] == 0


class FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on a machine without one: it
    completes when ``done`` says so, at the time it was recorded."""

    clock = [0.0]
    done = [False]
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        FakeEvent.clock[0] += 1.5
        self.t = FakeEvent.clock[0]

    def query(self):
        return FakeEvent.done[0]

    def elapsed_time(self, end):
        assert FakeEvent.done[0], "read before the event completed"
        return end.t - self.t


@pytest.fixture
def fake_cuda(monkeypatch):
    FakeEvent.clock[0], FakeEvent.done[0] = 0.0, False
    FakeEvent.made.clear()
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    return torch.device("cuda")


def test_stages_on_cuda_read_their_events_once_they_completed(
        tracer, fake_cuda):
    st = obs.Stages("pipe", ("a", "b", "c"))
    st.start(fake_cuda)
    for _ in range(3):
        st.mark(fake_cuda)
    assert len(FakeEvent.made) == 4         # one event per mark
    obs.resolve_device_times()              # nothing has completed
    events = tracer.events
    assert [e["name"] for e in events] == ["pipe.a", "pipe.b", "pipe.c"]
    assert all("args" not in e for e in events)
    FakeEvent.done[0] = True
    got = tracer.snapshot_events()          # resolves what completed
    assert [e["args"]["device_ms"] for e in got] == [1.5, 1.5, 1.5]
    assert tracer._device == []


def test_stages_with_tracing_off_make_no_event_and_no_span(off, fake_cuda):
    st = obs.Stages("pipe", ("a", "b"))
    st.start(fake_cuda)
    st.mark(fake_cuda)
    st.mark(fake_cuda)
    st.close()
    assert FakeEvent.made == []
    assert obs.get_tracer() is None


@pytest.mark.gpu
def test_a_fit_on_the_card_times_its_stages_by_cuda_events(points, tracer):
    """On the card each stage's ``device_ms`` comes from its CUDA events,
    read once the attempt's report read has waited for them (skipped
    where there is no card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage spans time CUDA events")
    res = cluster(points, EPS, MIN_PTS, engine="device-kernels",
                  device="cuda")
    assert len(res.attempts) == 2
    assert tracer._device == []           # every event read in its attempt
    events = tracer.snapshot_events()
    attempts = [e for e in events if e["name"] == "adaptive.attempt"]
    stages = [e for e in events if e["name"] in STAGES]
    assert len(stages) == 7 * len(attempts)
    for s in stages:
        (a,) = [a for a in attempts
                if a["ts"] <= s["ts"] and s["ts"] + s["dur"]
                <= a["ts"] + a["dur"]]
        assert 0.0 < s["args"]["device_ms"] <= a["dur"] * 1e-3
