"""roofline.shade_fused_sliced (%): kernel shade_fused's launches of a frame
on clustered lists (B2b: one list a (tile, log-Z slice)), their bound
(renderbench/kernels/bounds.py, on the reference's data, its sliced lists
counted) over their measured device ms.  It reads what roofline.shade_fused
reads, in the cells whose frames take B2's clustered variant."""

from renderbench.metrics._roofline import share


def read(t: dict):
    return share(t, "shade_fused")
