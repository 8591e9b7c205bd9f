"""glue_kernels (count): kernels and copies a frame outside the port's own
kernels."""


def read(t: dict):
    p = t.get("profile")
    if not p:
        return None
    return (p["kernel_count"] - sum(p["port_count"].values())
            + p["copy_count"])
