"""One run of one cell: set-up, the measured window, the traced windows
(--trace 1), the check against the plain reference, and the result line.

Set-up builds the port's kernel library (cached in the checkout's
build/kernels), makes the cell's scene from the seed, stages every camera
of the cycle on the card and warms up and captures the cell's one program.
The window replays frames back to back, each at the next camera of the
cycle, with at most frames_in_flight frames issued and not yet complete
(the host waits on frame i - 2's completion event before it issues frame
i, as a double-buffered swap chain does): a closed loop of one client.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from renderbench import correct, profiling, scene, stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SETTLE_FRAMES = 3          # replays after the capture, before the window
MAX_WARM_CALLS = 8         # eager calls before a program must capture
CHECK_FRAMES = 2           # frames of the window, drawn from the seed, checked
BANNED = ("jax", "jaxlib", "flax", "lsr_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration, traffic, kernels and metric
    specs, each found by name in its own file."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    kernels = {}
    kdir = os.path.join(HERE, "kernels")
    for f in sorted(os.listdir(kdir)):
        if f.endswith(".json"):
            spec = load_json(os.path.join(kdir, f))
            kernels[spec["name"]] = spec

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell,
            "config": load_json(os.path.join(ROOT, cfg_entry["file"])),
            "traffic": load_json(os.path.join(HERE, "traffic",
                                              f"{cell['traffic']}.json")),
            "kernels": kernels,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str):
    """The read(trace) function of renderbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "renderbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    lsr_tpu's (the whole name before the first dot)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def card_state() -> str:
    """The card's clocks, power, temperature and throttle reasons as
    nvidia-smi reads them, or why they could not be read."""
    q = ("clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu,"
         "clocks_event_reasons.active")
    try:
        p = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return p.stdout.strip() or p.stderr.strip()


class HostEvent:
    """A completion marker on the host clock: what a CUDA event is to the
    card, for a run on the CPU (the tests' route; run.py never takes it)."""

    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def event(dev):
    if dev.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return HostEvent()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Window:
    """The frames of the window: issues them with at most `inflight`
    outstanding and records an event before each (its start, once the
    frame before it is done) and a completion event after it."""

    def __init__(self, prog, traffic, start: int, ordinal: int,
                 inflight: int, keep, dev):
        self.prog, self.traffic, self.start, self.dev = (prog, traffic, start,
                                                         dev)
        self.ordinal, self.inflight, self.keep = ordinal, inflight, keep
        self.starts: list = []
        self.events: list = []
        self.issue_ms: list = []

    def frame(self) -> None:
        i = len(self.events)
        if i >= self.inflight:
            self.events[i - self.inflight].synchronize()
        k = self.ordinal
        ev0 = event(self.dev)
        ev0.record()
        self.starts.append(ev0)
        t0 = time.perf_counter()
        out = self.prog.call(scene.camera_of(self.traffic, self.start, k))
        self.issue_ms.append((time.perf_counter() - t0) * 1e3)
        ev = event(self.dev)
        ev.record()
        self.events.append(ev)
        self.keep(k, out)
        self.ordinal += 1


def set_up(cfg: dict, traffic: dict, seed: int, dev, trace: dict):
    """The cell's scene, its cameras staged and its program warmed up,
    captured and replayed SETTLE_FRAMES times; the seed draws where the
    camera cycle starts.  Records warmup_s (the eager calls) and capture_s
    (the call that captures) in trace.  Returns (program, inputs, the
    cycle's first camera, the next frame's ordinal)."""
    from renderbench import port_side

    on_card = dev.type == "cuda"
    inputs = scene.scene_inputs(cfg)
    start = scene.first_camera(traffic, seed)
    prog = port_side.Program(cfg, traffic, inputs, dev)
    sync(dev)

    # Warm-up and capture: the program's first calls, at the cycle's first
    # cameras, until one captures (on the CPU, which never captures, the
    # program's own count of eager calls).
    trace["warmup_s"] = 0.0
    ordinal = 0
    while True:
        t0 = time.perf_counter()
        prog.call(scene.camera_of(traffic, start, ordinal))
        sync(dev)
        ordinal += 1
        if prog.captures() or (not on_card and ordinal == prog.warm_calls):
            trace["capture_s"] = time.perf_counter() - t0
            break
        trace["warmup_s"] += time.perf_counter() - t0
        if ordinal >= MAX_WARM_CALLS:
            raise RuntimeError(f"no capture after {ordinal} calls")
    settle = []
    for _ in range(SETTLE_FRAMES):
        e0, e1 = event(dev), event(dev)
        e0.record()
        prog.call(scene.camera_of(traffic, start, ordinal))
        e1.record()
        sync(dev)
        settle.append(e0.elapsed_time(e1))
        ordinal += 1
    log(f"# warm-up {trace['warmup_s']:.3f} s, capture {trace['capture_s']:.3f}"
        f" s, {prog.captures()} capture(s); settle replays (ms) "
        f"{[round(m, 3) for m in settle]}")
    return prog, inputs, start, ordinal


def compare(cfg: dict, traffic: dict, inputs, start: int, kept: list,
            dev, controls=()):
    """The kept frames [(ordinal, compared outputs)] against the plain
    reference's at the same cameras.  Returns (the numbers of each frame,
    each frame's recorded raster calls, its shade calls); with controls,
    also {control: the numbers of each frame of the reference computed in
    that control's precision against the reference}."""
    from renderbench import ref_side

    ref = ref_side.Reference(cfg, traffic, inputs, start, dev)
    per_frame, rasters, shades = [], [], []
    ctl = {c: [] for c in controls}
    for k, got in kept:
        r_calls, s_calls = [], []
        t0 = time.perf_counter()
        want = ref.frame_outputs(k, rasters=r_calls, shades=s_calls)
        per_frame.append(correct.numbers(got, want))
        rasters.append(r_calls)
        shades.append(s_calls)
        log(f"# frame {k} (camera {scene.camera_of(traffic, start, k)}, "
            f"reference {time.perf_counter() - t0:.2f} s): {per_frame[-1]}")
        for c in controls:
            t0 = time.perf_counter()
            ctl[c].append(correct.numbers(ref.frame_outputs(k, control=c),
                                          want))
            log(f"# frame {k}, control {c} ({time.perf_counter() - t0:.2f}"
                f" s): {ctl[c][-1]}")
    if controls:
        return per_frame, rasters, shades, ctl
    return per_frame, rasters, shades


def run(args, t_start: float, device=None, bench=None) -> dict:
    """One run; returns the result dict (checks last).  t_start: the
    process's start on the perf_counter clock.  device: the card (cuda:0)
    unless given; the tests drive a run on the CPU, with no kernel
    library, no trace and the host clock for the device's.  bench: the
    parsed BENCHMARK.json (read from the checkout unless given)."""
    from renderbench import port_side
    from renderbench.kernels import bounds as bound_fns

    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = cell_spec(bench, args.workload)
    cfg, traffic, kernels = spec["config"], spec["traffic"], spec["kernels"]
    dev = device or torch.device("cuda", 0)
    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    on_card = dev.type == "cuda"
    traced = bool(args.trace) and on_card
    if on_card:
        build_s, built = port_side.load_library()
        log(f"# kernel library: {'built' if built else 'cached'} in "
            f"{build_s:.2f} s")
    trace: dict = {}
    prog, inputs, start, ordinal = set_up(cfg, traffic, args.seed, dev, trace)
    captures = prog.captures()

    sample = stats.Reservoir(CHECK_FRAMES, scene.rng_for(args.seed, 2))
    win = Window(prog, traffic, start, ordinal,
                 int(traffic["frames_in_flight"]),
                 lambda k, out: sample.offer((k, prog.compared(out))), dev)
    start_ev = event(dev)
    log(f"# card before the window: {card_state()}")
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    start_ev.record()
    while time.perf_counter() - t_first < args.seconds:
        win.frame()
    sync(dev)
    t_done = time.perf_counter()
    log(f"# card after the window: {card_state()}")
    n = len(win.events)
    ev_ms = [start_ev.elapsed_time(e) for e in win.events]
    gaps = stats.intervals(ev_ms[0], ev_ms)
    spans = [a.elapsed_time(b) for a, b in zip(win.starts, win.events)]
    trace["idle"] = {"frames_ms": sum(spans), "window_ms": ev_ms[-1]}
    metrics_e2e = {"frame_ms": stats.frame_ms(t_first, t_done, n),
                   "frame_ms_p95": stats.percentile(gaps, 95),
                   "setup_s": setup_s}
    log(f"# window: {n} frames in {t_done - t_first:.3f} s; frame ms median "
        f"{statistics.median(gaps):.4f}, p95 {metrics_e2e['frame_ms_p95']:.4f}"
        f", max {max(gaps):.4f}; the card waited on the host "
        f"{ev_ms[-1] - sum(spans):.3f} of {ev_ms[-1]:.3f} ms; captures "
        f"{prog.captures()} (after set-up {captures})")
    blocks = [round(statistics.median(gaps[i:i + 50]), 3)
              for i in range(0, n, 50)]
    log(f"# interval medians of each 50 frames: {blocks}")
    if prog.captures() != captures:
        raise RuntimeError("the program captured inside the window")

    breakdown = None
    if traced:
        trace["enqueue_ms"] = list(win.issue_ms)
        before = port_side.counters()
        calls0 = win.ordinal
        prof = profiling.busy_replays(win.frame,
                                      int(traffic["profile_frames"]), kernels)
        per = profiling.per_frame(prof)
        frames = win.ordinal - calls0
        after = port_side.counters()
        launches = {k: (after[k] - before[k]) / frames for k in after}
        for kname, ks in kernels.items():
            want = sum(launches.get(c, 0) for c in ks["counters"])
            got = per["port_count"][kname]
            if want != got:
                per["complete"] = False
                log(f"# profile: {kname} {got} launches a frame in the "
                    f"trace, {want} by the launch counters")
        host_win = profiling.busy(lambda: [win.frame() for _ in range(
            int(traffic["profile_frames"]))], int(traffic["profile_frames"]),
            kernels, with_host=True)
        sync(dev)
        trace["profile"] = per
        log(f"# profile a frame: {json.dumps(per)}"
            f"; windows (kernels, copies) {prof['seen']}")
        breakdown = {"device_ops": profiling.top_ops(prof),
                     "idle_gaps": profiling.idle_gaps(host_win)}
        if prog.captures() != captures:
            raise RuntimeError("the program captured while traced")

    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    attempted = n
    kept = sorted(sample.items, key=lambda it: it[0])
    del prog, win, sample
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # The check: the plain reference at the sampled frames' cameras.
    t_ref = time.perf_counter()
    per_frame, rasters, shades = compare(cfg, traffic, inputs, start, kept,
                                         dev)
    if traced:
        calls = {"raster_direct": rasters, "shade_fused": shades}
        trace["bounds"] = {}
        for kname, ks in kernels.items():
            fn = ks["bound"] and getattr(bound_fns, ks["bound"])
            frames_calls = calls.get(kname)
            if not fn or not frames_calls or not any(frames_calls):
                continue
            counted = [fn(c) for c in frames_calls]
            b = sum(x[0] for x in counted) / len(counted)
            o = sum(x[1] for x in counted) / len(counted)
            trace["bounds"][kname] = {"bytes": b, "ops": o,
                                      "bound_ms": bound_fns.bound_ms(b, o)}
        log(f"# bounds a frame: {trace['bounds']}")
    del rasters, shades
    log(f"# reference: {len(kept)} frames in "
        f"{time.perf_counter() - t_ref:.1f} s")
    readings = correct.worst(per_frame)
    ok, checks = correct.judge(readings, correct.load_limits(args.workload),
                               min(CHECK_FRAMES, attempted),
                               len(per_frame))
    failed = sum(1 for nums in per_frame if any(
        nums.get(k, math.inf) > c["limit"] for k, c in checks.items()))
    if not ok and not failed:
        failed = max(1, len(kept) - len(per_frame))

    if traced:
        metrics = {}
        for m in spec["per_layer"]:
            v = reader(m["name"])(trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": metrics_e2e[m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1,
                   "memory_peak_bytes": memory_peak}
    if traced:
        device_info.update(busy_s=trace["profile"]["busy_s"],
                           window_s=trace["profile"]["window_s"])
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
