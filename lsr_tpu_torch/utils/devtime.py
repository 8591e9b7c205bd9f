"""Device timing by the slope method (port of lsr_tpu/utils/devtime.py).

A region is timed at two iteration counts, each window ending in a drain,
and the slope cancels the constant cost of the drain.  lsr_tpu drains with
a host readback of a scalar probe, because `jax.block_until_ready` did not
wait on the remote TPU link it was written on.  The port keeps the same
drain: `probe` reads a scalar derived from the output with `.item()`,
which waits for the card's queue up to that output.

The framework's analog of the reference's per-pass GPU timestamp queries
(hello_rendering_paths.cpp:111).
"""

from __future__ import annotations

import dataclasses
import time

import torch


def _first_tensor(out):
    """The first tensor leaf of a tensor, dict, list / tuple or dataclass."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        items = list(out.values())
    elif isinstance(out, (list, tuple)):
        items = list(out)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        items = [getattr(out, f.name) for f in dataclasses.fields(out)]
    else:
        return None
    for x in items:
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def probe(out) -> float:
    """Host-read a scalar derived from the first tensor leaf of `out`: the
    sum of its first 128 elements as float32 (the value is meaningless;
    reading it drains the queue through the result)."""
    x = _first_tensor(out)
    if x is None:
        raise TypeError(f"probe: no tensor in {type(out).__name__}")
    return float(x.reshape(-1)[:128].to(torch.float32).sum().item())


def slope_ms(fn, *args, iters=(4, 20)):
    """Steady-state ms/call of fn(*args) by the slope method.

    Returns (last_output, ms).  fn must be pure (it is re-invoked
    iters[0] + iters[1] times after one warmup call).
    """
    out = fn(*args)                     # warm
    probe(out)
    m_lo, m_hi = iters
    t = []
    for m in (m_lo, m_hi):
        t0 = time.perf_counter()
        for _ in range(m):
            out = fn(*args)
        probe(out)                      # drain
        t.append(time.perf_counter() - t0)
    ms = (t[1] - t[0]) / (m_hi - m_lo) * 1000.0
    return out, ms


def slope_ms_paired(fn, *args, iters=(2, 8), reps=3):
    """Slope timing with INTERLEAVED (lo, hi) pairs and error bars.

    Each of `reps` (lo, hi) pairs yields its own slope, so a slow window
    lands in both terms; the result is the mean (clamped at 0: a negative
    mean is measurement noise) and the standard error across reps.

    Returns (last_output, ms, stderr_ms).
    """
    out = fn(*args)                     # warm
    probe(out)
    m_lo, m_hi = iters
    slopes = []
    for _ in range(max(1, reps)):
        t = []
        for m in (m_lo, m_hi):
            t0 = time.perf_counter()
            for _ in range(m):
                out = fn(*args)
            probe(out)                  # drain
            t.append(time.perf_counter() - t0)
        slopes.append((t[1] - t[0]) / (m_hi - m_lo) * 1000.0)
    n = len(slopes)
    mean = sum(slopes) / n
    var = sum((s - mean) ** 2 for s in slopes) / max(1, n - 1)
    stderr = (var / n) ** 0.5
    return out, max(0.0, mean), stderr
