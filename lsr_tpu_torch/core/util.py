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


def device_const(values, device, dtype=torch.float32):
    """A small constant tensor on `device`, made without a device sync.

    torch.tensor(data, device="cuda") copies and then synchronizes the
    stream; staging host data with non_blocking=True does not, so a frame
    that builds its constants this way keeps the card's queue full."""
    return torch.as_tensor(np.asarray(values), dtype=dtype).to(
        device, non_blocking=True)


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
