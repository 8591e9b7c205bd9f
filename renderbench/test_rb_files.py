"""Every cell, configuration, traffic mix, kernel and metric of
BENCHMARK.json loads by name from its own files, and the file keeps to the
benchmark's contract."""

import json
import os
import re

import pytest

from renderbench import harness
from renderbench.kernels import bounds

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["renderbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for item in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(item["why"]) <= 200 and "\n" not in item["why"]
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_and_workloads():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = harness.cell_spec(BENCH, cell)
    cfg, traffic = spec["config"], spec["traffic"]
    assert cfg["name"] == spec["cell"]["config"]
    assert traffic["name"] == spec["cell"]["traffic"]
    assert traffic["frames_in_flight"] >= 1
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cfg["precision"] == {"dtype": "float32", "tf32": False}
    limits = harness.correct.load_limits(cell)
    assert "ldr_diff_pct" in limits
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_reader_finds_nothing_in_an_empty_trace(name):
    assert harness.reader(name)({}) is None


def test_kernel_files():
    spec = harness.cell_spec(BENCH, CELLS[0])
    assert {"raster_direct", "shade_fused", "vis_windows",
            "vis_planes"} <= set(spec["kernels"])
    for k in spec["kernels"].values():
        assert k["symbols"] and k["counters"]
        if k["bound"]:
            assert callable(getattr(bounds, k["bound"]))
