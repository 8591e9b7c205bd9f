"""The run as a whole on the CPU at a tiny size: run.py refuses to run
without a card; a run driven past that check (the CPU, the kernels' plain
versions, the host clock) prints the result's schema, and comes out not
correct when the timed path is broken underneath."""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from renderbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def tiny_bench(tmp_path, cell):
    """BENCHMARK.json with the cell's configuration cut to 96x54 and small
    shadow maps (a copy under tmp_path)."""
    bench = copy.deepcopy(BENCH)
    name = {w["name"]: w for w in bench["workloads"]}[cell]["config"]
    entry = {c["name"]: c for c in bench["configs"]}[name]
    cfg = json.load(open(os.path.join(ROOT, entry["file"])))
    cfg["resolution"] = [96, 54]
    if "frame" in cfg:
        cfg["frame"].update(shadow_size=128, local_map=64, local_point=32,
                            vis_crop=[[28, 32], [34, 48], [54, 96]])
    else:
        cfg["pipeline"].update(local_map=64, local_point=32, sun_map=128)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    entry["file"] = str(path)
    return bench


def drive(tmp_path, cell, seed=2**31 + 17):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.5, trace=0)
    return harness.run(args, time.perf_counter(), device=torch.device("cpu"),
                       bench=tiny_bench(tmp_path, cell))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "renderbench/run.py", "--workload",
                        "paths_720p.ssao", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_schema_of_a_tiny_run(tmp_path):
    res = drive(tmp_path, "paths_720p.ssao")
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("ms", "s")
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)
