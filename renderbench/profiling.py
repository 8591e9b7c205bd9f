"""The profiler's trace of replayed frames.

busy and busy_replays are chip_smoke.py's _busy and _busy_replays (the
benchmark keeps its own copy): torch.profiler over a
window of n back-to-back frames, profiled again until two windows agree on
whole multiples of n kernels and copies, because the profiler drops some
or all of the kernels of short graph replays now and then.  A window
that never agrees is returned as the fullest one, flagged incomplete.

Each device activity is classed by its name: a copy ("Memcpy"), a memset
("Memset") or a kernel; a kernel is one of the port's own where a pattern
of renderbench/kernels/<name>.json is in its name, glue otherwise.
"""

from __future__ import annotations

import sys
import time

import torch

PROFILE_PAD_S = 0.005  # host idle at each end of a profiled window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def kind_of(name: str) -> str:
    if "Memcpy" in name:
        return "copy"
    if "Memset" in name:
        return "memset"
    return "kernel"


def port_kernel(name: str, kernels: dict):
    """The port kernel (a renderbench/kernels file's name) whose symbol
    pattern is in `name`, or None for glue."""
    for kname, spec in kernels.items():
        if any(p in name for p in spec["symbols"]):
            return kname
    return None


def _union_us(spans) -> float:
    """The length of the union of (start, end) spans, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy(run, n: int, kernels: dict, with_host: bool = False) -> dict:
    """torch.profiler over run() (n frames, warm): the device activities
    and the window's length by CUDA events.  Returns the window's
    counts and sums (us) by class and by port kernel, the union of its
    device activities, each activity (name, start, end), and with_host
    the host's operations (name, start, end) too.  The window holds
    PROFILE_PAD_S of host idle before and after, so that an activity
    stamped near its edge by the device clock still falls inside it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if with_host:
        acts.append(ProfilerActivity.CPU)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    res = {"n": n, "window_us": e0.elapsed_time(e1) * 1e3,
           "count": {"kernel": 0, "copy": 0, "memset": 0},
           "us": {"kernel": 0.0, "copy": 0.0, "memset": 0.0},
           "port_count": {k: 0 for k in kernels},
           "port_us": {k: 0.0 for k in kernels}, "by_name": {},
           "device": [], "host": []}
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kind_of(e.name)
            res["count"][k] += 1
            res["us"][k] += t - s
            res["device"].append((e.name, s, t))
            nm = res["by_name"].setdefault(e.name, [0, 0.0])
            nm[0] += 1
            nm[1] += t - s
            pk = port_kernel(e.name, kernels) if k == "kernel" else None
            if pk is not None:
                res["port_count"][pk] += 1
                res["port_us"][pk] += t - s
        elif with_host:
            res["host"].append((e.name, s, t))
    res["busy_us"] = _union_us([(s, t) for _, s, t in res["device"]])
    return res


def busy_replays(call, n: int, kernels: dict, tries: int = 6) -> dict:
    """busy over windows of n calls of call, up to tries windows, until one
    has kernels and copies that are nonzero whole multiples of n and equal
    to those of an earlier window ("complete"; then both windows are
    kept).  Where none agree, the fullest window, complete False.  Returns
    {"windows": [the kept windows], "complete", "seen": [(kernels, copies)
    of every window]}."""
    seen = []
    for _ in range(tries):
        res = busy(lambda: [call() for _ in range(n)], n, kernels)
        k, c = res["count"]["kernel"], res["count"]["copy"]
        same = [r for r in seen if (r["count"]["kernel"], r["count"]["copy"])
                == (k, c)]
        seen.append(res)
        if k and k % n == 0 and c % n == 0 and same:
            return {"windows": [same[-1], res], "complete": True,
                    "seen": [(r["count"]["kernel"], r["count"]["copy"])
                             for r in seen]}
    best = max(seen, key=lambda r: r["count"]["kernel"])
    if not best["count"]["kernel"]:
        raise RuntimeError(f"torch.profiler saw no kernel in {tries} windows")
    counts = [(r["count"]["kernel"], r["count"]["copy"]) for r in seen]
    log(f"# torch.profiler: no two windows of {n} frames agreed on whole "
        f"multiples of {n} (kernels / copies {counts}): the fullest one's "
        f"numbers are lower bounds")
    return {"windows": [best], "complete": False, "seen": counts}


def per_frame(prof: dict) -> dict:
    """busy_replays' windows reduced to one frame: means over the kept
    windows, each divided by its n."""
    ws = prof["windows"]
    m = len(ws)

    def mean(get):
        return sum(get(w) / w["n"] for w in ws) / m

    out = {"window_ms": mean(lambda w: w["window_us"]) / 1e3,
           "busy_ms": mean(lambda w: w["busy_us"]) / 1e3,
           "complete": prof["complete"]}
    for k in ("kernel", "copy", "memset"):
        out[f"{k}_count"] = mean(lambda w, k=k: w["count"][k])
        out[f"{k}_ms"] = mean(lambda w, k=k: w["us"][k]) / 1e3
    names = ws[0]["port_count"]
    out["port_count"] = {k: mean(lambda w, k=k: w["port_count"][k])
                         for k in names}
    out["port_ms"] = {k: mean(lambda w, k=k: w["port_us"][k]) / 1e3
                      for k in names}
    out["window_s"] = sum(w["window_us"] for w in ws) / 1e6
    out["busy_s"] = sum(w["busy_us"] for w in ws) / 1e6
    return out


def top_ops(prof: dict, k: int = 10) -> list:
    """[[name, seconds]] of the k device operations (by name) that took the
    most time in the kept windows."""
    tot: dict = {}
    for w in prof["windows"]:
        for name, (_, us) in w["by_name"].items():
            tot[name] = tot.get(name, 0.0) + us / 1e6
    return [[name[:120], s] for name, s in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(window: dict, k: int = 10) -> list:
    """[[what the host was doing, seconds]] of the k longest gaps between
    device activities of a window profiled with_host: each gap named by the
    innermost host operation under way when the gap began ("host idle"
    where none was)."""
    dev = sorted((s, t) for _, s, t in window["device"])
    gaps, end = [], None
    for s, t in dev:
        if end is not None and s > end:
            gaps.append((end, s))
        end = t if end is None else max(end, t)
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
        under = [(s, t, nm) for nm, s, t in window["host"] if s <= g0 < t]
        name = min(under, key=lambda x: x[1] - x[0])[2] if under else \
            "host idle"
        out.append([name[:120], (g1 - g0) / 1e6])
    return out
