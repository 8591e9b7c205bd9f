"""capture_s (s): host seconds of the call that captures the frame's CUDA
graph and replays it once, synchronised."""


def read(t: dict):
    return t.get("capture_s")
