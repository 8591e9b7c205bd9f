"""Shared by the roofline readers: a kernel's share of its roofline."""


def share(t: dict, kernel: str):
    """100 * the frame's summed bound ms of the kernel's launches over
    their summed measured ms, or None where the kernel did not run or its
    bound was not counted."""
    p, b = t.get("profile"), t.get("bounds", {}).get(kernel)
    if not p or b is None or not p["port_count"].get(kernel):
        return None
    ms = p["port_ms"][kernel]
    return None if ms <= 0 else 100.0 * b["bound_ms"] / ms
