"""Benchmark / parity / soak harnesses, the Phase F / I / G machinery (port
of lsr_tpu/utils/harness.py).

Mirrors hello_rendering_paths.cpp's built-in harnesses:
- Phase F (:290-353): warmup + sampled frame timing per composition,
  min/avg/max ms + metadata as JSONL,
- Phase I (:389-414): per-composition low-res headless renders hashed and
  compared across backends; in the port the two backends are the CUDA
  kernel raster and the torch brute raster,
- Phase G (:355-387): timed soak cycling compositions with perturbations,
  judged against frame-time and rebuild-count acceptance thresholds.

Frames are drained with devtime.probe (a scalar read back to the host).
Every row keeps lsr_tpu's JSONL keys.  The emitters append JSON Lines;
the default paths are artifacts/torch_phase_*.jsonl.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from lsr_tpu_torch.core.util import resolve_device
from lsr_tpu_torch.utils.devtime import probe
from lsr_tpu_torch.utils.host import fetch


def write_jsonl(path: str, rows: List[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def ldr_hash(img_u8) -> str:
    """Stable content hash of an LDR image (hash_ldr_color_buffer analog,
    hello_rendering_paths.cpp:1315): blake2b-16 of the C-contiguous bytes,
    then the shape's text; lsr_tpu's digest for the same image."""
    arr = np.ascontiguousarray(fetch(img_u8))
    h = hashlib.blake2b(arr.tobytes(), digest_size=16)
    h.update(str(arr.shape).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Phase F: benchmark
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BenchResult:
    name: str
    frames: int
    ms_min: float
    ms_avg: float
    ms_max: float
    meta: dict = dataclasses.field(default_factory=dict)

    def row(self) -> dict:
        return {
            "phase": "F", "composition": self.name, "frames": self.frames,
            "frame_ms_min": round(self.ms_min, 3),
            "frame_ms_avg": round(self.ms_avg, 3),
            "frame_ms_max": round(self.ms_max, 3),
            "fps_avg": round(1000.0 / max(self.ms_avg, 1e-6), 2),
            **self.meta,
        }


def measure_sync_floor(n: int = 5, device=None) -> float:
    """The per-drain constant (dispatch -> host readback round trip) of a
    trivial frame on `device` (default: the card), in ms: the median of n.
    Harness rows record it and report frame times net of it."""
    x = torch.zeros((8, 128), dtype=torch.float32,
                    device=resolve_device(device))
    probe(x + 1.0)                    # first drain
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        probe(x + 1.0)
        ts.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(ts))


def run_benchmark(name: str, frame_fn: Callable[[int], object],
                  warmup: int = 90, samples: int = 180,
                  jsonl_path: str | None = "artifacts/torch_phase_f_metrics.jsonl",
                  meta: dict | None = None, chunk: int = 30,
                  floor_ms: float = 0.0) -> BenchResult:
    """Time frame_fn(i) for `samples` frames after `warmup` (defaults match
    hello_rendering_paths.cpp:293-294).

    Frames are timed in chunks of `chunk` with ONE drain per chunk; the
    per-drain `floor_ms` constant is subtracted from each chunk, so the
    reported times are net device throughput; min/avg/max are over chunks.
    """
    out = None
    for i in range(warmup):
        out = frame_fn(i)
    if out is not None:
        probe(out)

    chunk_ms = []
    total = 0.0
    i = 0
    while i < samples:
        n = min(chunk, samples - i)
        t0 = time.perf_counter()
        for j in range(n):
            out = frame_fn(warmup + i + j)
        probe(out)
        dt = max((time.perf_counter() - t0) * 1000.0 - floor_ms, 0.0)
        chunk_ms.append(dt / n)
        total += dt
        i += n

    res = BenchResult(
        name=name, frames=samples,
        ms_min=min(chunk_ms), ms_avg=total / samples, ms_max=max(chunk_ms),
        meta={**(meta or {}), "chunk": chunk,
              "floor_ms": round(floor_ms, 2)},
    )
    if jsonl_path:
        write_jsonl(jsonl_path, [res.row()])
    return res


# ---------------------------------------------------------------------------
# Phase I: backend parity
# ---------------------------------------------------------------------------

def run_backend_parity(
    compositions: Dict[str, Dict[str, Callable[[int], object]]],
    warmup: int = 2, samples: int = 6,
    jsonl_path: str | None = "artifacts/torch_phase_i_backend_parity.jsonl",
    run_id: str | None = None,
):
    """compositions: {name: {backend_name: frame_fn(i) -> ldr_u8}}.

    Renders each composition on every backend (2 warmup + 6 hashed frames,
    hello_rendering_paths.cpp:398-401) and reports per-frame hash agreement.
    Returns {name: {"match": bool, "hashes": {backend: [hash,...]}}}.
    """
    results = {}
    rows = []
    for name, backends in compositions.items():
        hashes = {}
        for be, fn in backends.items():
            per_frame = []
            for i in range(warmup):
                probe(fn(i))
            for i in range(samples):
                per_frame.append(ldr_hash(fn(warmup + i)))
            hashes[be] = per_frame
        names = list(hashes)
        match = all(hashes[b] == hashes[names[0]] for b in names[1:])
        results[name] = {"match": match, "hashes": hashes}
        rows.append({
            "phase": "I", "composition": name, "backends": names,
            "match": match,
            "ldr_hash": hashes[names[0]][-1],
            **({"run_id": run_id} if run_id else {}),
        })
    if jsonl_path:
        write_jsonl(jsonl_path, rows)
    return results


# ---------------------------------------------------------------------------
# Phase G: soak
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SoakAcceptance:
    """hello_rendering_paths.cpp:362-369 thresholds."""

    max_avg_frame_ms: float = 50.0
    max_rebuilds: int = 24
    max_cycle_failures: int = 0


def _soak_controls(drain_every: int, device=None):
    """The same-window control probes on `device` (default: the card): a
    NO-OP frame (one tiny add dispatched `drain_every` times + one drain:
    the pure dispatch / drain cost per frame) and a FIXED-WORK probe (a
    constant chain of eight 512^2 float32 matmuls: device throughput,
    identical every call).  Run at cycle boundaries, they tell a degraded
    host or card from renderer time in the same run.  The matmuls are
    measurement code, not a kernel of the renderer."""
    device = resolve_device(device)
    a0 = torch.ones((512, 512), dtype=torch.float32, device=device)

    def fixed_body(a):
        for _ in range(8):
            a = torch.matmul(a, a0)
        return a

    def run_controls():
        x = torch.zeros((), dtype=torch.float32, device=device)
        t0 = time.perf_counter()
        for _ in range(drain_every):
            x = x + 1.0
        probe(x)
        noop_ms = (time.perf_counter() - t0) * 1000.0 / drain_every
        t0 = time.perf_counter()
        y = fixed_body(a0)
        probe(y)
        fixed_ms = (time.perf_counter() - t0) * 1000.0
        return noop_ms, fixed_ms

    # Warm the controls outside any timed window.
    run_controls()
    return run_controls


def _control_row(cycle, noop_ms, fixed_ms, run_id):
    return {"phase": "G_control", "cycle": cycle,
            "noop_ms_per_frame": round(noop_ms, 3),
            "fixed_work_ms": round(fixed_ms, 2),
            **({"run_id": run_id} if run_id else {})}


def run_soak(
    compositions: Dict[str, Callable[[int], object]],
    duration_s: float = 180.0,
    frames_per_cycle: int = 240,
    acceptance: SoakAcceptance | None = None,
    rt_registry=None,
    perturb: Callable[[int], None] | None = None,
    jsonl_path: str | None = "artifacts/torch_phase_g_soak.jsonl",
    run_id: str | None = None,
    floor_ms: float = 0.0,
    drain_every: int = 30,
    controls: bool = True,
    device=None,
):
    """Cycle compositions until duration_s elapses, perturbing between cycles
    (configure-toggle stress, hello_rendering_paths.cpp:1754).  Returns a
    report dict with pass/fail against the acceptance thresholds.

    Frames dispatch asynchronously with one drain per `drain_every` frames;
    each drain's `floor_ms` constant is credited back, so avg_frame_ms is
    net device throughput and the acceptance threshold applies net of the
    floor.  A cycle that raises counts as a cycle failure and the soak
    carries on (lsr_tpu's semantics): callers read cycle_failures and
    accepted.

    With `controls` on, a no-op-frame drain and a fixed-work probe run on
    `device` (default: the card) at every cycle boundary and land in
    G_control rows; control time is excluded from busy_ms.
    """
    acceptance = acceptance or SoakAcceptance()
    names = list(compositions)
    run_controls = _soak_controls(drain_every, device) if controls else None
    control_noop, control_fixed = [], []
    t_start = time.perf_counter()
    frame = 0
    cycle = 0
    failures = 0
    busy_ms = 0.0
    drains = 0
    while time.perf_counter() - t_start < duration_s:
        if run_controls is not None:
            noop_ms, fixed_ms = run_controls()
            control_noop.append(noop_ms)
            control_fixed.append(fixed_ms)
            if jsonl_path:
                write_jsonl(jsonl_path, [_control_row(cycle, noop_ms,
                                                      fixed_ms, run_id)])
        name = names[cycle % len(names)]
        fn = compositions[name]
        if perturb is not None:
            perturb(cycle)
        try:
            done = 0
            while done < frames_per_cycle:
                n = min(drain_every, frames_per_cycle - done)
                t0 = time.perf_counter()
                t_disp = 0.0
                out = None
                for _ in range(n):
                    td = time.perf_counter()
                    out = fn(frame)
                    t_disp += time.perf_counter() - td
                    frame += 1
                probe(out)
                chunk = max(
                    (time.perf_counter() - t0) * 1000.0 - floor_ms, 0.0)
                busy_ms += chunk
                drains += 1
                done += n
                if jsonl_path:
                    # dispatch_ms is the host's share (state staging and
                    # enqueueing); chunk minus dispatch is the queue drain.
                    write_jsonl(jsonl_path, [{
                        "phase": "G_chunk", "cycle": cycle,
                        "composition": name, "frames": n,
                        "ms_per_frame": round(chunk / n, 2),
                        "dispatch_ms_per_frame": round(
                            t_disp * 1000.0 / n, 2),
                        **({"run_id": run_id} if run_id else {}),
                    }])
                if time.perf_counter() - t_start >= duration_s:
                    break
        except Exception:  # cycle failure is data, not a crash (Phase G)
            failures += 1
        cycle += 1

    if run_controls is not None:
        # One more control sample after the last cycle, so a run that
        # degraded mid-soak shows it at both ends.
        noop_ms, fixed_ms = run_controls()
        control_noop.append(noop_ms)
        control_fixed.append(fixed_ms)
        if jsonl_path:
            write_jsonl(jsonl_path, [_control_row(cycle, noop_ms, fixed_ms,
                                                  run_id)])
    avg_ms = busy_ms / max(frame, 1)
    rebuilds = rt_registry.rebuild_count if rt_registry is not None else 0
    ok = (
        avg_ms <= acceptance.max_avg_frame_ms
        and rebuilds <= acceptance.max_rebuilds
        and failures <= acceptance.max_cycle_failures
    )
    report = {
        "phase": "G", "frames": frame, "cycles": cycle,
        "avg_frame_ms": round(avg_ms, 3), "rebuilds": rebuilds,
        "cycle_failures": failures, "accepted": ok,
        "floor_ms": round(floor_ms, 2), "drains": drains,
        **({"run_id": run_id} if run_id else {}),
    }
    if control_noop:
        report["control_noop_ms_min"] = round(min(control_noop), 3)
        report["control_noop_ms_max"] = round(max(control_noop), 3)
        report["control_fixed_ms_min"] = round(min(control_fixed), 2)
        report["control_fixed_ms_max"] = round(max(control_fixed), 2)
    if jsonl_path:
        write_jsonl(jsonl_path, [report])
    return report
