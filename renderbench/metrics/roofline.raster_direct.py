"""roofline.raster_direct (%): kernel raster_direct's launches of a frame, their bound
(renderbench/kernels/bounds.py, on the reference's data) over their
measured device ms."""

from renderbench.metrics._roofline import share


def read(t: dict):
    return share(t, "raster_direct")
