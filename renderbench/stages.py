"""The stage phase of a traced run (--trace 1): where a replayed frame's
device time goes, stage by stage, read from the spans inside
lsr_tpu_torch (its utils.trace).

phase() builds the cell's program anew with the port's tracing on
(trace.enable()), warms it up and captures it as harness.set_up does, and
replays STAGE_FRAMES frames, synchronising after each and reading:
- each stage's device ms at that replay (Jitted.stage_ms(): external event
  pairs recorded into the graph at capture, re-timed by every replay), and
  the graph's own device span (an external pair as its first and last
  nodes);
Then WINDOWS windows of as many frames, issued as the measured window
issues them (harness.Window, frames_in_flight in flight): each frame's
device span as the window times it, its host call, and the host spans
jit.call and jit.replay; a control window of another program may run
before each and after the last (the untraced program, for the cost of
tracing: the card's slow and fast states, PERF.md section 6, take turns
within a process, so the two are compared window by window).
Each top-level stage's kernel, memcpy and memset nodes come from the
capture (exact; the same for every replay).  Then torch.profiler runs over
the program's replays, issued as the measured window issues them: windows
of whole frames until two agree (profiling.busy_replays) for the profiler's
own count of kernels, copies and memsets a frame, set against the graph's
nodes plus jit's copies outside the graph; and one window with host
activities, whose idle gaps are each named by the innermost port span
(a record_function range of utils.trace) that encloses the gap's start,
"caller" where none does.  Each gap goes to standard error.

The first capture's set-up spans (jit.capture and its children, the kernel
library's load) are taken from the port's kept list as the measured
program left it, not measured again.

Run it from the root of a checkout on a machine with a CUDA card:

    python3 -m renderbench.stages --workload <cell> --seed <n>

It sets the cell's measured program up as a run does (untraced), runs the
phase with that program's windows as its control, and prints one JSON
line: the stage metrics (metrics/_stages.py), what tracing costs (cost()),
the set-up spans, the stage nodes against the profiler's count and the
idle gaps by span.  The harness does not run the phase yet (PERF.md,
section 7).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys

import torch

from renderbench import harness, profiling, scene

STAGE_FRAMES = 20         # replays read stage by stage, and a window's frames
WINDOWS = 3               # windows of frames issued as the measured window's
GAP_LOG_US = 20.0         # idle gaps at least this long are logged one by one
SETUP_SPANS = {"jit.capture": "capture_s",
               "jit.capture.record": "capture_record_s",
               "jit.capture.instantiate": "capture_instantiate_s",
               "jit.capture.first_replay": "capture_first_replay_s"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def port_trace():
    """lsr_tpu_torch.utils.trace, or None where the port has none."""
    try:
        from lsr_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def jitted_of(prog):
    """The utils.jit.Jitted that runs a port_side.Program's frames."""
    return prog.jitted if prog.jitted is not None else prog.pipe._jitted.jitted


def setup_spans(ptrace) -> dict:
    """Seconds of the set-up spans that the port kept: the first capture
    (jit.capture and its children, by SETUP_SPANS' names), the kernel
    library's load (library_s) and the warm-ups before that capture
    (warm_up_s, summed)."""
    kept = ptrace.kept()
    out = {}
    cap = next((s for s in kept if s.name == "jit.capture"), None)
    for s in kept:
        if s.name == "cuda_build.load" and "library_s" not in out:
            out["library_s"] = s.host_ms / 1e3
        if cap is not None and (s is cap or s.parent is cap):
            out[SETUP_SPANS.get(s.name, s.name)] = s.host_ms / 1e3
    if cap is not None:
        out["warm_up_s"] = sum(s.host_ms for s in kept if s.name ==
                               "jit.warm_up" and s.start_ns < cap.start_ns
                               ) / 1e3
    return out


def named_gaps(window: dict, names: set) -> list:
    """[(start us from the window's first activity, length us, name)] of
    every gap between device activities of a window profiled with_host,
    each named by the innermost host range among `names` enclosing its
    start ("caller" where none does), in time order."""
    dev = sorted((s, t) for _, s, t in window["device"])
    host = [(s, t, nm) for nm, s, t in window["host"] if nm in names]
    out, end = [], None
    for s, t in dev:
        if end is not None and s > end:
            under = [(t1 - s1, nm) for s1, t1, nm in host if s1 <= end < t1]
            out.append((end - dev[0][0], s - end,
                        min(under)[1] if under else "caller"))
        end = t if end is None else max(end, t)
    return out


def _families(stages: list, value) -> dict:
    """{family: sum of value(stage)} over the stages, by trace.family
    (an unknown name under "unknown")."""
    from lsr_tpu_torch.utils import trace as ptrace

    out: dict = {}
    for s in stages:
        fam = ptrace.family(s.name) or "unknown"
        out[fam] = out.get(fam, 0) + value(s)
    return out


def _ops(nodes: dict) -> int:
    return nodes["kernel"] + nodes["memcpy"] + nodes["memset"]


def phase(cfg: dict, traffic: dict, kernels: dict, seed: int, dev,
          control=None) -> dict:
    """The stage phase (see the module docstring) on the card `dev`;
    returns the trace dict's "stages" entry, {} where the port has no
    utils.trace.  control: where given, a function run before each of the
    phase's windows and after the last, returning ([device span ms], [host
    call ms]) of a window of another program (main's untraced one)."""
    ptrace = port_trace()
    if ptrace is None:
        log("# stages: the port has no utils.trace; no stage phase")
        return {}
    out = {"setup_spans": setup_spans(ptrace)}
    log(f"# stages: set-up spans of the first capture (s) "
        f"{json.dumps(out['setup_spans'])}")
    ptrace.enable()
    try:
        out.update(_traced(ptrace, cfg, traffic, kernels, seed, dev,
                           control))
    finally:
        ptrace.disable()
        ptrace.drain()
    return out


def _traced(ptrace, cfg, traffic, kernels, seed, dev, control) -> dict:
    prog, _, start, ordinal = harness.set_up(cfg, traffic, seed, dev, {})
    captures = prog.captures()
    j = jitted_of(prog)
    ptrace.drain()
    per: dict = {"graph_ms": [], "cover": []}
    fam_ms: dict = {}
    stage_ms: dict = {}
    for _ in range(STAGE_FRAMES):
        prog.call(scene.camera_of(traffic, start, ordinal))
        torch.cuda.synchronize(dev)
        ordinal += 1
        cap = j.last.trace
        ms = j.stage_ms()
        top = cap.top()
        graph = cap.device_ms()
        per["graph_ms"].append(graph)
        per["cover"].append(sum(ms[s.name] for s in top) / graph)
        for fam, v in _families(top, lambda s: ms[s.name]).items():
            fam_ms.setdefault(fam, []).append(v)
        for name, v in ms.items():
            stage_ms.setdefault(name, []).append(v)
    # Frames issued as the measured window issues them, WINDOWS windows of
    # STAGE_FRAMES: each frame's device span and host call, its host spans;
    # with a control, the control's window before each and after the last.
    for k in ("window_span_ms", "issue_ms", "replay_ms", "call_ms",
              "control_span_ms", "control_issue_ms"):
        per[k] = []

    def run_control():
        if control is not None:
            span, issue = control()
            per["control_span_ms"] += span
            per["control_issue_ms"] += issue

    for _ in range(WINDOWS):
        run_control()
        ptrace.drain()
        win = harness.Window(prog, traffic, start, ordinal,
                             int(traffic["frames_in_flight"]),
                             lambda k, o: None, dev)
        for _ in range(STAGE_FRAMES):
            win.frame()
        torch.cuda.synchronize(dev)
        ordinal = win.ordinal
        spans = ptrace.drain()
        per["window_span_ms"] += [a.elapsed_time(b) for a, b in
                                  zip(win.starts, win.events)]
        per["issue_ms"] += win.issue_ms
        per["replay_ms"] += [s.host_ms for s in spans
                             if s.name == "jit.replay"]
        per["call_ms"] += [s.host_ms for s in spans if s.name == "jit.call"]
    run_control()
    cap = j.last.trace
    top = cap.top()
    fam_nodes = _families(top, lambda s: s.nodes["kernel"] + s.nodes["memcpy"])
    unstaged = cap.unstaged()
    graph_ops = sum(_ops(s.nodes) for s in top) + _ops(unstaged)
    res = {"frames": STAGE_FRAMES, "family_ms": fam_ms,
           "family_kernels": fam_nodes,
           "stage_ms": {k: statistics.median(v) for k, v in stage_ms.items()},
           "stage_nodes": {s.name: s.nodes for s in cap.stages},
           "unstaged": unstaged, "outside_ops": j.last.outside_ops, **per}
    medians = {k: round(v, 4) for k, v in res["stage_ms"].items()}
    log(f"# stages: {STAGE_FRAMES} traced replays; median device ms by "
        f"stage {json.dumps(medians)}; nodes by stage "
        f"{json.dumps(res['stage_nodes'])}; unstaged "
        f"{json.dumps(unstaged)}; jit's copies outside the graph "
        f"{j.last.outside_ops}")
    log(f"# stages: graph span median {statistics.median(per['graph_ms']):.4f}"
        f" ms, cover median {100 * statistics.median(per['cover']):.2f}%; "
        f"issued as the window: frame span mean "
        f"{statistics.mean(per['window_span_ms']):.4f} ms, jit.call median "
        f"{statistics.median(per['call_ms']):.4f} ms, jit.replay median "
        f"{statistics.median(per['replay_ms']):.4f} ms")

    # The profiler over the same program's replays, issued as the window
    # issues them.
    win = harness.Window(prog, traffic, start, ordinal,
                         int(traffic["frames_in_flight"]),
                         lambda k, o: None, dev)
    n = int(traffic["profile_frames"])
    prof = profiling.per_frame(profiling.busy_replays(win.frame, n, kernels))
    counted = prof["kernel_count"] + prof["copy_count"] + prof["memset_count"]
    res["reconcile"] = {"graph_ops": graph_ops,
                        "outside_ops": j.last.outside_ops,
                        "profiler_ops": counted,
                        "complete": prof["complete"]}
    log(f"# stages: a frame's operations: the graph's {graph_ops} nodes "
        f"(kernels, memcpys, memsets) + {j.last.outside_ops} copies outside "
        f"it = {graph_ops + j.last.outside_ops}; the profiler's {counted} "
        f"(complete {prof['complete']})")
    ptrace.drain()
    host_win = profiling.busy(lambda: [win.frame() for _ in range(n)], n,
                              kernels, with_host=True)
    torch.cuda.synchronize(dev)
    names = {s.name for s in ptrace.drain()}
    gaps = named_gaps(host_win, names)
    by_name: dict = {}
    for at, us, name in gaps:
        c = by_name.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += us
        if us >= GAP_LOG_US:
            log(f"# idle gap {us / 1e3:.4f} ms at +{at / 1e3:.3f} ms, under "
                f"{name}")
    summary = {k: [c, round(us / 1e3, 4)] for k, (c, us) in by_name.items()}
    log(f"# idle gaps of {n} frames by enclosing span (count, ms): "
        f"{json.dumps(summary)}")
    res["gaps_ms"] = {k: us / 1e3 for k, (_, us) in by_name.items()}
    res["gaps_top"] = [[name, us / 1e3] for _, us, name in
                       sorted(gaps, key=lambda g: -g[1])[:10]]
    if prog.captures() != captures:
        raise RuntimeError("the traced program captured after its set-up")
    return res


def _windows(values: list) -> list:
    """The means of values taken STAGE_FRAMES at a time."""
    return [statistics.mean(values[i:i + STAGE_FRAMES])
            for i in range(0, len(values), STAGE_FRAMES)]


def cost(res: dict) -> dict:
    """What tracing costs, from a phase run with a control of the same
    cell untraced: each traced window's mean device span a frame against
    the mean of the control windows before and after it (pct_by_window),
    and the median host call, traced against untraced."""
    traced = _windows(res["window_span_ms"])
    ctl = _windows(res["control_span_ms"])
    pct = [100.0 * (t / ((a + b) / 2) - 1.0)
           for t, a, b in zip(traced, ctl, ctl[1:])]
    return {"traced_span_ms": traced, "untraced_span_ms": ctl,
            "pct_by_window": pct, "pct": statistics.median(pct),
            "traced_call_ms": statistics.median(res["issue_ms"]),
            "untraced_call_ms": statistics.median(res["control_issue_ms"]),
            "jit_call_ms": statistics.median(res["call_ms"])}


def main(argv=None) -> int:
    """python3 -m renderbench.stages --workload <cell> --seed <n>: the
    cell's measured program set up untraced, then the stage phase, with a
    window of the untraced program before each of its windows and after
    the last; prints one JSON line: the stage metrics
    (metrics/_stages.readings), the cost of tracing, the set-up spans, the
    stages' nodes against the profiler's count and the idle gaps by
    span."""
    p = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    from renderbench import port_side
    from renderbench.metrics import _stages

    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec = harness.cell_spec(bench, args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    dev = torch.device("cuda", 0)
    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    port_side.load_library()
    prog, _, start, ordinal = harness.set_up(cfg, traffic, args.seed, dev, {})

    def untraced():
        nonlocal ordinal
        win = harness.Window(prog, traffic, start, ordinal,
                             int(traffic["frames_in_flight"]),
                             lambda k, o: None, dev)
        for _ in range(STAGE_FRAMES):
            win.frame()
        torch.cuda.synchronize(dev)
        ordinal = win.ordinal
        return ([a.elapsed_time(b) for a, b in zip(win.starts, win.events)],
                list(win.issue_ms))

    res = phase(cfg, traffic, spec["kernels"], args.seed, dev, untraced)
    del prog
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev),
           "metrics": _stages.readings(res),
           "setup_spans": res.get("setup_spans")}
    if res.get("window_span_ms"):
        c = out["cost"] = cost(res)
        out.update({k: res[k] for k in ("stage_ms", "stage_nodes",
                                        "unstaged", "reconcile", "gaps_ms",
                                        "gaps_top")})
        log(f"# stages: tracing on: a frame's device span by window "
            f"{[round(v, 4) for v in c['traced_span_ms']]} ms traced, "
            f"{[round(v, 4) for v in c['untraced_span_ms']]} untraced "
            f"around them: {[round(v, 3) for v in c['pct_by_window']]}%; "
            f"the host call (median) {c['traced_call_ms']:.4f} ms traced "
            f"(jit.call {c['jit_call_ms']:.4f}), "
            f"{c['untraced_call_ms']:.4f} ms untraced")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
