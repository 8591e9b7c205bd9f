"""Headless presentation edge, the SDL runtime analog (port of
lsr_tpu/utils/viewer.py).

With no display, 'present' means: device -> host copy of the LDR canvas,
then PNG files / image sequences / terminal previews.  The frame loop
mirrors SdlRuntime's pump-update-present structure
(platform/sdl/sdl_runtime.hpp:24) with the window replaced by a sink.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np

from lsr_tpu_torch.core.util import FrameClock
from lsr_tpu_torch.io.png import save_canvas_png
from lsr_tpu_torch.utils.host import fetch_image


def ascii_preview(canvas_u8, rows: int = 28, cols: int = 76) -> str:
    """Luma ASCII art of a bottom-left-origin canvas (top row first)."""
    img = fetch_image(canvas_u8).astype(np.float32)
    lum = img.mean(-1) if img.ndim == 3 else img
    h, w = lum.shape
    chars = " .:-=+*#%@"
    ys = np.linspace(h - 1, 0, rows).astype(int)
    xs = np.linspace(0, w - 1, cols).astype(int)
    return "\n".join(
        "".join(chars[min(9, int(lum[y, x] / 25.6))] for x in xs) for y in ys
    )


class HeadlessViewer:
    """Frame-loop runner: calls frame_fn(time_s, dt) -> LDR canvas each tick,
    writes PNG frames (and optional terminal previews)."""

    def __init__(self, out_dir: str = "out/frames", name: str = "frame",
                 echo_ascii: bool = False):
        self.out_dir = out_dir
        self.name = name
        self.echo_ascii = echo_ascii
        self.clock = FrameClock()
        os.makedirs(out_dir, exist_ok=True)

    def present(self, canvas_u8, frame_index: int) -> str:
        path = os.path.join(self.out_dir, f"{self.name}_{frame_index:04d}.png")
        save_canvas_png(path, fetch_image(canvas_u8))
        if self.echo_ascii:
            print(ascii_preview(canvas_u8))
        return path

    def run(self, frame_fn: Callable[[float, float], object],
            frames: int = 60,
            on_frame: Optional[Callable[[int, float], None]] = None):
        """Render `frames` frames; returns (paths, avg_ms)."""
        paths = []
        t_total = 0.0
        for i in range(frames):
            dt = self.clock.tick()
            t0 = time.perf_counter()
            canvas = frame_fn(self.clock.time, dt)
            paths.append(self.present(canvas, i))
            t_total += time.perf_counter() - t0
            if on_frame:
                on_frame(i, dt)
        return paths, (t_total / max(frames, 1)) * 1000.0
