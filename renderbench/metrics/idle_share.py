"""idle_share (%): the share of the measured window (before any profiling)
in which the card waited on the host: 1 - (the frames' device spans, each
from an event recorded before the frame's issue, which completes once the
frame before is done, to its completion event) / (the window, from its
start event to the last frame's completion).  CUDA events only: no
profiler runs in the window to stretch it."""


def read(t: dict):
    w = t.get("idle")
    if not w or w["window_ms"] <= 0:
        return None
    return 100.0 * (1.0 - w["frames_ms"] / w["window_ms"])
