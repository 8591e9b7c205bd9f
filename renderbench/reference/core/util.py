"""Small helpers shared by the port's modules, and the engine utilities of
lsr_tpu/core/util.py (SI units, logging, Result, FrameClock; analogs of the
reference's core/units.hpp, core/log.hpp, core/result.hpp and
core/time.hpp)."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Generic, Optional, TypeVar

import numpy as np
import torch

T = TypeVar("T")


_CONSTS: dict = {}


def device_const(values, device, dtype=torch.float32):
    """A small constant tensor on `device`, made once per (values, dtype,
    device) and shared by every later call.

    A frame's constants are the same every frame, so the first call (a
    jitted frame's warm-up) uploads them, from host memory staged with
    non_blocking=True (no device sync), and a captured frame only reads
    them: a copy from pageable host memory cannot be captured.  A value
    that changes from frame to frame is a tensor input, not a constant.
    The tensor is shared: writing to it in place raises at its next use."""
    a = np.array(values)
    device = torch.device(device)
    key = (a.shape, a.dtype.str, a.tobytes(), dtype, device)
    hit = _CONSTS.get(key)
    if hit is None:
        t = torch.as_tensor(a, dtype=dtype).to(device, non_blocking=True)
        hit = _CONSTS[key] = (t, t._version)
    t, version = hit
    if t._version != version:
        raise RuntimeError(f"device_const: the shared constant {a.tolist()} "
                           f"was written in place")
    return t


def f32_on(x, device):
    """x as a 0-d f32 tensor on `device`: a tensor (a camera's zn / zf, data
    as in lsr_tpu) as it lies when it is one already, a host number as a
    memoised device_const."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return device_const(x, device)


def default_device() -> torch.device:
    """The device the port's entry points use when the caller names none:
    the CUDA card.  Raises when there is no card; the CPU (the kernels'
    plain versions) is only ever used when asked for with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "lsr_tpu_torch runs on the CUDA card unless told otherwise, and "
            "torch.cuda.is_available() is False: pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; None means default_device()."""
    return default_device() if device is None else torch.device(device)


def cdiv(a: int, b: int) -> int:
    """Ceiling division of host integers."""
    return -(-a // b)


# --- units (core/units.hpp: 1.0 world unit = 1 meter) ------------------------

METER = 1.0
KILOMETER = 1000.0
CENTIMETER = 0.01
MILLIMETER = 0.001
SECOND = 1.0
MILLISECOND = 1e-3
GRAVITY = (0.0, -9.81, 0.0)  # -Y down, 9.81 m/s^2


def meters(x: float) -> float:
    return x * METER


# --- logging (core/log.hpp) --------------------------------------------------

_LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}
_min_level = "info"


def set_log_level(level: str) -> None:
    global _min_level
    if level not in _LEVELS:
        raise ValueError(f"unknown log level {level}")
    _min_level = level


def _log(level: str, msg: str) -> None:
    if _LEVELS[level] < _LEVELS[_min_level]:
        return
    stream = sys.stderr if level in ("warn", "error") else sys.stdout
    print(f"[lsr:{level}] {msg}", file=stream)


def log_debug(msg: str) -> None:
    _log("debug", msg)


def log_info(msg: str) -> None:
    _log("info", msg)


def log_warn(msg: str) -> None:
    _log("warn", msg)


def log_error(msg: str) -> None:
    _log("error", msg)


# --- Result (core/result.hpp) ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Result(Generic[T]):
    """Value-or-error; errors are strings (the reference's Result pattern)."""

    value: Optional[T] = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error

    @staticmethod
    def success(value: T) -> "Result[T]":
        return Result(value=value)

    @staticmethod
    def failure(error: str) -> "Result[T]":
        return Result(error=error or "unknown error")

    def unwrap(self) -> T:
        if not self.ok:
            raise RuntimeError(f"Result.unwrap on error: {self.error}")
        return self.value


# --- FrameClock (core/time.hpp) ----------------------------------------------

class FrameClock:
    """Wall-clock frame timing: dt, total time, frame counter, FPS average."""

    def __init__(self, now_fn=time.perf_counter):
        self._now = now_fn
        self._last = now_fn()
        self._start = self._last
        self.dt = 0.0
        self.time = 0.0
        self.frame = 0

    def tick(self) -> float:
        now = self._now()
        self.dt = now - self._last
        self._last = now
        self.time = now - self._start
        self.frame += 1
        return self.dt

    def fps(self) -> float:
        return self.frame / self.time if self.time > 0 else 0.0
