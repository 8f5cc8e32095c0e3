"""The port's fault-tolerance runtime (``repro_torch.launch.cluster``):
twins of ``tests/test_cluster_runtime.py`` over the port's
``train.checkpoint`` -- straggler guard, crash-restore loop, heartbeat --
on CPU tensors, and the port's ``on_restore`` hook, which rewinds a data
stream to the restored checkpoint's cursor."""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.cluster import (Heartbeat, StepGuard,
                                        StragglerDetected, run_resilient)
from repro_torch.train import checkpoint as ckpt


def _state(n: int):
    return {"params": {"w": torch.zeros((n,))}, "opt": {},
            "step": torch.zeros((), dtype=torch.int32)}


def test_step_guard_retries_transient_failures():
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return state, {"ok": 1}

    guard = StepGuard(max_retries=3)
    out = guard(flaky, {}, {})
    assert out[1]["ok"] == 1
    assert calls["n"] == 3


def test_step_guard_raises_after_max_retries():
    def always_fails(state, batch):
        raise RuntimeError("hard")

    guard = StepGuard(max_retries=2)
    with pytest.raises(RuntimeError):
        guard(always_fails, {}, {})


def test_step_guard_detects_straggler():
    guard = StepGuard(factor=3.0, min_samples=3)

    def fast(s, b):
        time.sleep(0.005)
        return s, {}
    for _ in range(5):
        guard(fast, {}, {})

    def slow(s, b):
        time.sleep(0.2)
        return s, {}
    with pytest.raises(StragglerDetected):
        guard(slow, {}, {})


def test_run_resilient_crash_restore():
    """Inject a crash mid-run; the loop must restore from the latest
    checkpoint and still complete all steps with the right final state."""
    state = _state(4)

    def step_fn(state, batch):
        return {**state, "step": state["step"] + 1,
                "params": {"w": state["params"]["w"] + 1.0}}, \
            {"loss": torch.zeros(())}

    crashed = {"done": False}

    def inject(i):
        if i == 7 and not crashed["done"]:
            crashed["done"] = True
            return RuntimeError("simulated node failure")
        return None

    with tempfile.TemporaryDirectory() as d:
        final, ran = run_resilient(
            state, step_fn, lambda: {}, ckpt_dir=d, num_steps=10,
            ckpt_every=5, inject_failure=inject)
        assert int(final["step"]) == 10
        # w incremented exactly once per counted step (no double-apply)
        np.testing.assert_allclose(final["params"]["w"].numpy(), 10.0)
        assert ckpt.latest_step(d) == 10


def test_run_resilient_straggler_checkpoints_before_raising():
    state = _state(2)
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] > 6:
            time.sleep(0.3)
        else:
            time.sleep(0.005)
        return {**state, "step": state["step"] + 1}, {}

    guard = StepGuard(factor=3.0, min_samples=3)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(StragglerDetected):
            run_resilient(state, step_fn, lambda: {}, ckpt_dir=d,
                          num_steps=20, ckpt_every=100, guard=guard)
        assert ckpt.latest_step(d) is not None   # emergency checkpoint


def test_heartbeat_staleness():
    with tempfile.TemporaryDirectory() as d:
        hb0 = Heartbeat(d, 0)
        hb1 = Heartbeat(d, 1)
        hb0.beat()
        hb1.beat()
        assert hb0.stale_hosts(timeout_s=5.0) == []
        time.sleep(0.15)
        hb0.beat()
        assert hb0.stale_hosts(timeout_s=0.1) == [1]


def test_crash_restore_rewinds_the_stream_with_on_restore(tmp_path):
    """A crash at step 3 restores the step-2 checkpoint; ``on_restore``
    rebuilds the pipeline from its saved cursor, so the final state
    equals an uninterrupted run's bit for bit (without the hook the
    stream runs on, as in the reference, and the restored steps see
    other batches)."""
    pipe_args = (97, 5, 2)

    def step_fn(state, batch):
        x = batch.to(torch.float32).sum(0)
        return {**state, "step": state["step"] + 1,
                "params": {"w": state["params"]["w"] * 0.5 + x}}, {}

    def run(hook: bool, crash: bool, d):
        pipe = {"p": TokenPipeline(*pipe_args, seed=4)}
        restored = []

        def on_restore(extra):
            restored.append(extra["pipeline"]["cursor"])
            pipe["p"] = TokenPipeline.from_state(*pipe_args,
                                                 extra["pipeline"])

        fired = {"done": False}

        def inject(i):
            if crash and i == 3 and not fired["done"]:
                fired["done"] = True
                return RuntimeError("simulated node failure")
            return None

        final, _ = run_resilient(
            _state(6), step_fn,
            lambda: torch.from_numpy(pipe["p"].next_batch()["tokens"]),
            ckpt_dir=str(d), num_steps=6, ckpt_every=2,
            pipeline_state=lambda: {"pipeline": pipe["p"].state()},
            inject_failure=inject,
            on_restore=on_restore if hook else None)
        return final, restored

    whole, _ = run(True, False, tmp_path / "whole")
    rewound, cursors = run(True, True, tmp_path / "rewound")
    drifted, _ = run(False, True, tmp_path / "drifted")
    assert cursors == [2]
    assert int(rewound["step"]) == int(whole["step"]) == 6
    assert torch.equal(rewound["params"]["w"], whole["params"]["w"])
    assert not torch.equal(drifted["params"]["w"], whole["params"]["w"])
    assert os.path.exists(tmp_path / "rewound" / "step_000000006")
