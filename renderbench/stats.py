"""The window's arithmetic: frame time, percentiles and the seeded
sample of frames that the check compares."""

from __future__ import annotations

import numpy as np


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of values, by linear interpolation
    between closest ranks (numpy's default), over all of them."""
    if not values:
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def frame_ms(t_first_issue: float, t_last_done: float, frames: int) -> float:
    """Host ms a frame: the window from the first timed frame's issue to
    the last frame's completion (host clock, seconds), over the frames."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return (t_last_done - t_first_issue) * 1e3 / frames


def intervals(start_to_first_ms: float, event_ms: list) -> list:
    """Completion-to-completion intervals (ms) of the window's frames: the
    first from the window's start event to frame 0's completion event, then
    each frame's completion after the one before.  event_ms[i]: ms from the
    start event to frame i's completion event."""
    out = [start_to_first_ms]
    out += [b - a for a, b in zip(event_ms, event_ms[1:])]
    return out


class Reservoir:
    """A uniform sample of at most k items from a stream of unknown length
    (algorithm R), its choices drawn from rng: the frames that the check
    compares, drawn from the seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
