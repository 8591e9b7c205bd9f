"""kernel_ms (ms): device ms a frame in the port's own CUDA kernels, the
activities whose names hold a symbol of renderbench/kernels/*.json."""


def read(t: dict):
    p = t.get("profile")
    if not p:
        return None
    return sum(p["port_ms"].values())
