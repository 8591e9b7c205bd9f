"""The stage phase (stages.py) and its readings (metrics/_stages.py): on the
CPU, each reading is None without the phase and the right number from a
synthetic phase dict, idle gaps are named by the innermost port span
around their start, and the set-up spans are those of the first capture;
and the cost of tracing pairs each traced window with the untraced ones
around it; on the card (marked `card`), for each cell, the operations the
captured graph's stages and its unstaged nodes hold, with jit's copies
outside the graph, equal the profiler's kernels, copies and memsets a
frame, exactly, and every family of the cell reads a time."""

import json
import os
import subprocess
import sys
import types

import pytest

from renderbench import stages
from renderbench.conftest import require_card
from renderbench.metrics import _stages

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 4100000021
FAMILIES_OF = {"flagship_1080p.orbit": {"cull", "shadows", "raster",
                                        "lighting", "post"},
               "paths_720p.ssao": {"cull", "shadows", "raster", "lighting",
                                   "ssao", "post"}}

PHASE = {"family_ms": {"cull": [1.0, 3.0, 2.0], "lighting": [9.0, 7.0, 8.0]},
         "family_kernels": {"cull": 120, "lighting": 0},
         "cover": [0.97, 0.99, 0.98], "replay_ms": [0.02, 0.05, 0.03, 0.04],
         "setup_spans": {"capture_record_s": 6.5,
                         "capture_instantiate_s": 1.25}}


@pytest.mark.parametrize("given", [None, {}, {"setup_spans": {}}])
def test_readings_without_the_phase(given):
    assert _stages.readings(given) == {}
    assert _stages.family_ms(given, "cull") is None
    assert _stages.family_kernels(given, "cull") is None
    assert _stages.stage_cover(given) is None
    assert _stages.launch_ms(given) is None
    assert _stages.setup_s(given, "capture_record_s") is None


def test_readings_of_a_phase():
    got = _stages.readings(PHASE)
    assert got == {"stage_ms.cull": 2.0, "stage_ms.lighting": 8.0,
                   "stage_kernels.cull": 120, "stage_kernels.lighting": 0,
                   "stage_cover": pytest.approx(98.0), "launch_ms": 0.035,
                   "capture_record_s": 6.5, "capture_instantiate_s": 1.25}
    assert "stage_ms.ssao" not in got and "stage_kernels.post" not in got


def test_gaps_named_by_the_innermost_port_span():
    """Gaps between device activities (us) take the name of the shortest
    enclosing host range among the port's span names; an operation that
    is no port span (aten::copy_) names nothing, "caller" where no port
    span encloses the gap's start."""
    window = {"device": [("k", 0, 10), ("k", 5, 20), ("k", 30, 40),
                         ("k", 41, 50), ("k", 90, 95)],
              "host": [("jit.call", 15, 45), ("jit.copy_in", 18, 25),
                       ("aten::copy_", 19, 24), ("jit.replay", 38, 44)]}
    names = {"jit.call", "jit.copy_in", "jit.replay"}
    assert stages.named_gaps(window, names) == [
        (20, 10, "jit.copy_in"), (40, 1, "jit.replay"), (50, 40, "caller")]


def _span(name, ms, start, parent=None):
    return types.SimpleNamespace(name=name, host_ms=ms, start_ns=start,
                                 parent=parent)


def test_setup_spans_of_the_first_capture():
    """The first jit.capture's own span and its children, the library's
    load and the warm-ups before that capture; a later capture's spans are
    not taken."""
    lib = _span("cuda_build.load", 900.0, 0)
    w1, w2 = _span("jit.warm_up", 1000.0, 1), _span("jit.warm_up", 500.0, 2)
    cap = _span("jit.capture", 8000.0, 3)
    kids = [_span("jit.capture.record", 6000.0, 4, cap),
            _span("jit.capture.instantiate", 1500.0, 5, cap),
            _span("jit.capture.first_replay", 30.0, 6, cap)]
    later = _span("jit.capture", 400.0, 7)
    late_kid = _span("jit.capture.record", 300.0, 8, later)
    kept = [lib, w1, w2, cap, *kids, _span("jit.warm_up", 70.0, 7), later,
            late_kid]
    ptrace = types.SimpleNamespace(kept=lambda: kept)
    assert stages.setup_spans(ptrace) == {
        "library_s": 0.9, "warm_up_s": 1.5, "capture_s": 8.0,
        "capture_record_s": 6.0, "capture_instantiate_s": 1.5,
        "capture_first_replay_s": 0.03}


def test_cost_pairs_each_window_with_its_controls():
    """Each traced window's mean span against the mean of the untraced
    windows before and after it; the calls' medians."""
    f = stages.STAGE_FRAMES
    res = {"window_span_ms": [10.0] * f + [12.0] * f,
           "control_span_ms": [9.0] * f + [11.0] * f + [13.0] * f,
           "issue_ms": [1.0, 2.0, 3.0], "control_issue_ms": [0.5, 0.7],
           "call_ms": [0.9, 1.1]}
    c = stages.cost(res)
    assert c["traced_span_ms"] == [10.0, 12.0]
    assert c["untraced_span_ms"] == [9.0, 11.0, 13.0]
    assert c["pct_by_window"] == [0.0, 0.0] and c["pct"] == 0.0
    assert (c["traced_call_ms"], c["untraced_call_ms"],
            c["jit_call_ms"]) == (2.0, 0.6, 1.0)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_stage_nodes_reconcile_with_the_profiler(cell):
    """The stage phase at the cell's size (python -m renderbench.stages, a
    process of its own, as a run is one): the kernel, memcpy and memset
    nodes of the captured graph (its top-level stages' and the rest) plus
    jit's copies outside the graph equal the profiler's count of a frame's
    kernels, copies and memsets, in complete windows; each family of the
    cell reads a time and a node count, and its stages cover at least 95%
    of the graph's device span.  (In one process after another cell's
    phase, the profiler's windows once came two operations short of
    36,075, in every window.)"""
    require_card()
    p = subprocess.run([sys.executable, "-m", "renderbench.stages",
                        "--workload", cell, "--seed", str(SEED)], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    rec = out["reconcile"]
    assert rec["complete"], rec
    assert rec["graph_ops"] + rec["outside_ops"] == rec["profiler_ops"], rec
    got = out["metrics"]
    fams = {k.split(".", 1)[1] for k in got if k.startswith("stage_ms.")}
    assert fams == FAMILIES_OF[cell]
    assert {k.split(".", 1)[1] for k in got
            if k.startswith("stage_kernels.")} == FAMILIES_OF[cell]
    assert got["stage_cover"] >= 95.0
