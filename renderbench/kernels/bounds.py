"""What a kernel's launches need at least, counted from the inputs: the
bytes each input is read once and each output written once, and the f32
operations, as these inputs need them.  The counts come from the plain
reference's own data for the same frame (its setups, G-buffer and light
lists), never from the port's intermediates.  A kernel's file under
renderbench/kernels names its counting function here ("bound").

bound_ms is the least time of a launch on the card: the larger of bytes
over the peak bandwidth and operations over the f32 peak, the published
peaks of one NVIDIA H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import torch

from renderbench.reference.lighting.shade_kernel import (
    light_live,
    slice_lists,
    tile_planes,
    walk_chunks,
)

PEAK_BYTES = 3.35e12    # HBM3, bytes a second
PEAK_F32 = 67e12        # f32 operations a second outside the tensor cores

RASTER_OPS = 25   # a (triangle, pixel) pair: 3 edge functions, the
                  # coverage test, the 1/w sum and the depth
LIGHT_OPS = 60    # one live local light at one pixel
SUN_OPS = 60      # the sun's BRDF, the view vector and the sum, a pixel
REC_BYTES = 64    # a triangle's setup record: 16 f32
LIGHT_BYTES = 128  # a light's record: 32 f32
GBUF_BYTES = 52   # what a covered pixel reads: 13 f32 planes
HDR_BYTES = 12    # what a pixel writes: 3 f32


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES, n_ops / PEAK_F32) * 1e3


def raster_pairs(setup, width: int, height: int) -> int:
    """(triangle, pixel) pairs inside the bboxes of the valid triangles,
    clipped to the target (bboxes are inclusive)."""
    b = setup.bbox[setup.valid].to(torch.int64)
    x0, x1 = b[:, 0].clamp(0, width - 1), b[:, 2].clamp(0, width - 1)
    y0, y1 = b[:, 1].clamp(0, height - 1), b[:, 3].clamp(0, height - 1)
    return int(((x1 - x0 + 1).clamp(min=0) * (y1 - y0 + 1).clamp(min=0))
               .sum())


def raster_direct(calls: list) -> tuple:
    """(bytes, ops) of a frame's B1 launches, one recorded raster call
    each: every valid triangle's record read once, every pixel's depth
    (and, tracking ids, its triangle id) written once, RASTER_OPS a pair
    inside a valid triangle's bbox."""
    n_bytes = n_ops = 0
    for c in calls:
        st, w, h = c["setup"], c["width"], c["height"]
        n_bytes += REC_BYTES * int(st.valid.sum())
        n_bytes += (8 if c["track_ids"] else 4) * w * h
        n_ops += RASTER_OPS * raster_pairs(st, w, h)
    return n_bytes, n_ops


def live_pairs(gbuf, tile_rec, counts, kinds, n_shadowed: int,
               slices: int, th: int = 64, tw: int = 128,
               chunk: int = 8) -> tuple:
    """(live (pixel, light) pairs, those of them whose light has a
    local-shadow plane): the pairs whose light can add anything at the
    pixel (covered, in range, facing it, inside a spot's cone), counted
    with the reference's light_live over the reference's light lists."""
    ph, pw = gbuf.shape[1:]
    g = tile_planes(gbuf[:14], th, tw, ph // th, pw // tw)
    px, py, pz, nx, ny, nz = g[0], g[1], g[2], g[3], g[4], g[5]
    cov = g[6] > 0.0
    live_n = shadowed_n = 0
    for sl, rec, cnt in slice_lists(tile_rec, counts, slices):
        in_slice = None if sl is None else g[13] == float(sl)
        for blk in walk_chunks(rec, cnt, chunk):
            live = light_live(blk, px, py, pz, nx, ny, nz, cov, kinds)
            if in_slice is not None:
                live = live & in_slice
            live_n += int(live.sum())
            shadowed_n += int((live & (blk[..., 28] < n_shadowed)[..., None])
                              .sum())
    return live_n, shadowed_n


def shade_fused(calls: list) -> tuple:
    """(bytes, ops) of a frame's B2 launches, one recorded shade call
    each: a covered pixel's 13 G-buffer planes and an uncovered pixel's
    coverage read once, each tile's count and list entries and each
    light's record read once, one plane texel a live shadowed
    (pixel, light) pair, 3 f32 written a pixel; LIGHT_OPS a live (pixel,
    light) pair and SUN_OPS a covered pixel."""
    n_bytes = n_ops = 0
    for c in calls:
        gbuf, w, h = c["gbuf"], c["width"], c["height"]
        cov = int((gbuf[6, :h, :w] > 0.0).sum())
        planes = c["vis_planes"]
        n_shadowed = 0 if planes is None else planes.shape[0] - 1
        live, shadowed = live_pairs(gbuf, c["tile_rec"], c["counts"],
                                    c["lights"].kinds, n_shadowed,
                                    c["slices"])
        cap = c["tile_rec"].shape[1] // max(c["slices"], 1)
        counts = c["counts"].to(torch.int64).clamp(max=cap)
        n_bytes += GBUF_BYTES * cov + 4 * (w * h - cov)
        n_bytes += 4 * counts.numel() + 4 * int(counts.sum())
        n_bytes += LIGHT_BYTES * int(c["lights"].count)
        n_bytes += 4 * shadowed + HDR_BYTES * w * h
        n_ops += LIGHT_OPS * live + SUN_OPS * cov
    return n_bytes, n_ops
