"""roofline.shade_fused (%): kernel shade_fused's launches of a frame, their bound
(renderbench/kernels/bounds.py, on the reference's data) over their
measured device ms."""

from renderbench.metrics._roofline import share


def read(t: dict):
    return share(t, "shade_fused")
