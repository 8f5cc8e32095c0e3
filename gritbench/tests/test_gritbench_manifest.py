"""The manifest against the benchmark's contract, and every file a cell
needs found by name."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from gritbench import harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gritbench/run.py"]
    assert BENCH["paths"] == ["gritbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_with_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text_fields():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and key != "source" or group == "configs" \
                        and key == "source":
                    v = e[key]
                    assert 1 <= len(v) <= 200 and "\n" not in v \
                        and "\t" not in v, (e["name"], key)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(names) == len(set(names))
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_every_cell_finds_its_files_by_name():
    for name in CELLS:
        cell = harness.find_cell(name, BENCH)
        assert cell.config["name"] == next(
            w["config"] for w in BENCH["workloads"] if w["name"] == name)
        assert (ROOT / "gritbench" / "drivers"
                / f"{cell.traffic['kind']}.py").exists()
        assert harness.driver(cell.traffic["kind"]).Driver
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))


def test_configurations_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key != "d"
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in CELLS:
        cell = harness.find_cell(name, BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_every_per_layer_metric_moves_an_end_to_end_metric_of_its_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert harness.reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_one_layer_name_per_layer_and_rooflines_in_percent():
    for m in BENCH["per_layer"]:
        assert m["layer"] == m["layer"].strip() and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_the_command_names_only_files_under_paths():
    for word in BENCH["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert word.split("/")[0] in BENCH["paths"]


def test_files_under_paths_are_named_from_name_characters():
    ok = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for p in (ROOT / "gritbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert ok.match(str(p.relative_to(ROOT))), p


def test_the_readers_return_nothing_on_nothing():
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"])({}) is None


def test_the_readers_read_their_context():
    ctx = {"fits": [{"attempts": 2, "host_reads": 80},
                    {"attempts": 3, "host_reads": 90}],
           "estimate_caps_s": 3.5, "stages_s": {"neighbors": 0.1,
                                                 "merge": 0.3},
           "dist_kernel_s": 0.004, "dist_bound_s": 0.001,
           "trace": {"busy_s": 2.5, "window_s": 10.0}}
    want = {"fit.attempts": 2.5, "fit.host_reads": 85.0,
            "fit.estimate_caps_s": 3.5, "fit.neighbors_ms": 100.0,
            "fit.merge_ms": 300.0, "fit.dist_kernel_roofline": 25.0,
            "device_idle_share.fit": 0.75}
    readers = sorted(p.stem for p in (ROOT / "gritbench" / "metrics").glob("*.py")
                     if p.stem != "__init__")
    assert {m["name"] for m in BENCH["per_layer"]} <= set(readers)
    for name in readers:
        assert harness.reader(name)(ctx) == pytest.approx(want[name])


def test_readers_are_plain_functions_of_their_context():
    for m in BENCH["per_layer"]:
        src = (ROOT / "gritbench" / "metrics" / f"{m['name']}.py").read_text()
        tree = ast.parse(src)
        assert not [n for n in ast.walk(tree)
                    if isinstance(n, (ast.Import, ast.ImportFrom))], m["name"]
