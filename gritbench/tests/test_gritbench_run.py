"""``run.py`` refuses to run without a card or without the program, and
the rest of a run, driven on the CPU at a small size, comes out correct
on the sound program and not correct with the timed path broken
underneath: a label altered where it is produced, a fit that returns an
earlier state unchanged, half of the points left out.  The fit driver's
set-up makes a fixed store of inputs whatever a fit takes, and its
window cycles over that store."""

import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gritbench import data, harness  # noqa: E402

sys.path.insert(0, str(ROOT / "gritbench"))
import run as run_py  # noqa: E402


def _no_result(out: str) -> bool:
    for line in out.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run([sys.executable, "gritbench/run.py", "--workload",
                        "fit.ss-varden-3d", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "no CUDA device" in p.stderr


def test_run_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gritbench", tmp_path / "gritbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "gritbench/run.py", "--workload",
                        "fit.ss-varden-3d", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert _no_result(p.stdout)


#: eps and MinPts by d at 3,000 points: cores, borders and noise all occur
SMALL = {3: (300.0, 40), 5: (120.0, 10)}


def small(name):
    """The cell at 3,000 points, with eps and MinPts cut with it."""
    cell = harness.find_cell(name)
    eps, min_pts = SMALL[int(cell.config["d"])]
    cell.config = dict(cell.config, n=3000, eps=eps, min_pts=min_pts)
    return cell


def go(name, seed=2 ** 31 + 3):
    return run_py.run_cell(name, seed, 1.0, False, device="cpu",
                           cell=small(name))


@pytest.mark.parametrize("name", ["fit.ss-varden-3d", "fit.ss-simden-5d"])
def test_the_sound_program_is_correct(name):
    out = go(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    e2e = {m["name"] for m in small(name).end_to_end}
    assert set(out["metrics"]) == e2e


@pytest.fixture
def engine(monkeypatch):
    import repro_torch.engine as eng
    return monkeypatch, eng


def test_a_label_altered_where_it_is_produced_fails(engine):
    monkeypatch, eng = engine
    real = eng.cluster

    def altered(*a, **k):
        res = real(*a, **k)
        i = int(np.flatnonzero(res.core)[0])
        res.labels = res.labels.copy()
        res.labels[i] = res.labels.max() + 1
        return res
    monkeypatch.setattr(eng, "cluster", altered)
    out = go("fit.ss-varden-3d")
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["label_errors"]["value"] >= 1


def test_a_fit_that_returns_its_last_state_unchanged_fails(engine):
    monkeypatch, eng = engine
    real = eng.cluster
    first = []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    monkeypatch.setattr(eng, "cluster", stale)
    out = go("fit.ss-varden-3d")
    assert not out["correct"]


def test_half_of_the_points_left_out_fails(engine):
    monkeypatch, eng = engine
    real = eng.cluster

    def half(x, *a, **k):
        m = (len(x) + 1) // 2
        res = real(x[:m], *a, **k)
        res.labels = np.concatenate([res.labels,
                                     np.full(len(x) - m, -1, np.int64)])
        res.core = np.concatenate([res.core, np.zeros(len(x) - m, bool)])
        return res
    monkeypatch.setattr(eng, "cluster", half)
    out = go("fit.ss-varden-3d")
    assert not out["correct"] and out["failed"] >= 1


def fit_driver(cell, seed, seconds):
    run = run_py.Run(cell=cell, seed=seed, seconds=seconds, trace=False,
                     device="cpu")
    return harness.driver(cell.traffic["kind"]).Driver(run)


@pytest.mark.parametrize("fit_s", [0.01, 0.3])
def test_set_up_makes_the_store_of_inputs_whatever_a_fit_takes(engine,
                                                                fit_s):
    monkeypatch, eng = engine

    def stub(x, *a, **k):
        time.sleep(fit_s)
        return types.SimpleNamespace(labels=np.zeros(len(x), np.int64),
                                     core=np.zeros(len(x), bool),
                                     n_clusters=0, attempts=[])
    monkeypatch.setattr(eng, "cluster", stub)
    cell = small("fit.ss-varden-3d")
    seed = 2 ** 31 + 11
    drv = fit_driver(cell, seed, float(harness.manifest()["run_seconds"]))
    drv.setup()
    store = cell.traffic["input_orders"]
    assert store == 16 and len(drv.inputs) == store
    n = len(drv.pts)
    for s, x in enumerate(drv.inputs):
        order = data.row_order(seed, drv.first + s, n)
        assert np.array_equal(x, drv.pts[order])


def test_the_window_cycles_the_store_and_each_fit_is_judged_in_its_order():
    cell = small("fit.ss-varden-3d")
    drv = fit_driver(cell, 2 ** 31 + 5, 0.0)
    drv.setup()
    store = cell.traffic["input_orders"]
    t0 = time.perf_counter()
    drv.cluster(drv.inputs[0], drv.eps, drv.min_pts,
                engine=cell.traffic["engine"], device="cpu")
    drv.run.seconds = 2 * (store + 1) * (time.perf_counter() - t0)
    drv.window(None)
    n, warm = drv.window_fits, drv.first
    assert n > store
    got = [k for k, _, _ in drv.fits[warm:warm + n]]
    assert got == [drv.first + i % store for i in range(n)]
    drv.close()
    correct, attempted, failed, checks = drv.judge()
    assert correct and attempted == n and failed == 0, checks
    # a fit put back with another order than it got is wrong
    _, labels, core = drv.fits[warm + store]
    drv.fits[warm + store] = (drv.first + store, labels, core)
    correct, _, failed, checks = drv.judge()
    assert not correct and failed == 1
    assert checks["core_flag_errors"]["value"] >= 1


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct_and_the_control_is_not():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gritbench import control
    out = run_py.run_cell("fit.ss-varden-3d", 7, 1.0, False, device="cuda",
                          cell=small("fit.ss-varden-3d"))
    assert out["correct"] and out["device"]["platform"] == "gpu"
    nums = control.control_numbers(small("fit.ss-varden-3d"), 7, "cuda")
    assert nums["core_flag_errors"] + nums["label_errors"] > 0
