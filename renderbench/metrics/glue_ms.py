"""glue_ms (ms): device ms a frame outside the port's own kernels: every
other kernel, copy and memset of the replayed frame."""


def read(t: dict):
    p = t.get("profile")
    if not p:
        return None
    return (p["kernel_ms"] - sum(p["port_ms"].values()) + p["copy_ms"]
            + p["memset_ms"])
