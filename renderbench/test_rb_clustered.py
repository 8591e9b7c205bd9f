"""The cell paths_1080p_768.clustered: its configuration, traffic, check
file and metric load by name; the configuration is paths_720p's but for
the resolution and the light count; B2b's roofline reads the shade_fused
kernel's launches; and a run of the cell on the CPU at a small size
(160x96, 200 lights, the shadow maps cut, every other key the file's) ends
correct."""

import argparse
import copy
import json
import os
import time

import torch

from renderbench import correct, harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELL = "paths_1080p_768.clustered"
METRIC = "roofline.shade_fused_sliced"


def test_the_cell_loads_by_name():
    spec = harness.cell_spec(BENCH, CELL)
    cfg, traffic = spec["config"], spec["traffic"]
    assert spec["cell"]["chips"] == 1
    assert (cfg["name"], traffic["name"]) == ("paths_1080p_768", "clustered")
    assert traffic["composition"] == "clustered_forward"
    assert cfg["program"] == "preset_pipeline"
    assert cfg["resolution"] == [1920, 1080]
    assert sum(g["count"] for g in cfg["scene"]["lights"]) == 768
    assert {m["name"] for m in spec["end_to_end"]} == {"frame_ms", "setup_s"}
    layer = {m["name"] for m in spec["per_layer"]}
    assert METRIC in layer and "roofline.shade_fused" not in layer
    assert set(correct.load_limits(CELL)) >= {"ldr_diff_pct", "ldr_mean_abs"}
    entry = {c["name"]: c for c in BENCH["configs"]}["paths_1080p_768"]
    assert entry["reduced"] == cfg["reduced"] == ["resolution", "scene"]
    assert set(cfg["departures"]) == set(cfg["reduced"])


def test_the_config_is_paths_720p_at_1080p_and_768_lights():
    def load(name):
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            return json.load(f)

    new, old = load("paths_1080p_768"), load("paths_720p")
    same = set(old) - {"name", "source", "reduced", "departures", "assumed",
                       "resolution", "scene"}
    assert all(new[k] == old[k] for k in same)
    lights = copy.deepcopy(old["scene"]["lights"])
    lights[2]["count"] = 758
    assert new["scene"] == dict(old["scene"], lights=lights)
    with open(os.path.join(HERE, "traffic", "ssao.json")) as f:
        ssao = json.load(f)
    with open(os.path.join(HERE, "traffic", "clustered.json")) as f:
        clustered = json.load(f)
    for k in ("path", "frames_in_flight", "profile_frames"):
        assert clustered[k] == ssao[k]


def test_the_metric_reads_shade_fused():
    read = harness.reader(METRIC)
    assert read({}) is None
    t = {"profile": {"port_count": {"shade_fused": 1.0},
                     "port_ms": {"shade_fused": 2.0}},
         "bounds": {"shade_fused": {"bound_ms": 0.05}}}
    assert read(t) == 2.5
    t["profile"]["port_count"]["shade_fused"] = 0.0
    assert read(t) is None


def small_bench(tmp_path):
    """BENCHMARK.json with the cell's configuration at 160x96 and 200
    lights, shadow maps cut (a copy under tmp_path)."""
    bench = copy.deepcopy(BENCH)
    entry = {c["name"]: c for c in bench["configs"]}["paths_1080p_768"]
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    cfg["resolution"] = [160, 96]
    cfg["scene"]["lights"][2]["count"] = 190
    cfg["pipeline"].update(local_map=64, local_point=32, sun_map=128)
    path = tmp_path / "paths_1080p_768.json"
    path.write_text(json.dumps(cfg))
    entry["file"] = str(path)
    return bench


def test_a_small_run_is_correct(tmp_path):
    args = argparse.Namespace(workload=CELL, seed=3 * 2**31 + 11,
                              seconds=0.5, trace=0)
    res = harness.run(args, time.perf_counter(), device=torch.device("cpu"),
                      bench=small_bench(tmp_path))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"frame_ms", "setup_s"}
    for c in res["checks"].values():
        assert c["value"] == 0.0
