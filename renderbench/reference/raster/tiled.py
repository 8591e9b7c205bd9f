"""The camera and shadow rasters of the reference: the plain route of the
port's kernel B1 (rasterize_direct), frozen.

rasterize_direct keeps the port's signature and runs what the port runs
for CPU tensors on any device: rasterize_brute, or rasterize_brute per
band of a band_h slot stack.  Both resolve (min depth, first submitted),
which is B1's rule with or without its spatial sort.  max_supers_per_tile,
a count of the kernel's own lists, is not worked out (None).

Each call is also offered to the recorders that record() opens, so that
the benchmark can count what a raster of these inputs needs.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from renderbench.reference.raster.brute import rasterize_brute
from renderbench.reference.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ, TriSetup

_SUPER = 256      # triangles per super-chunk (slot padding of the atlas)

# Setups with more rows than this take kernel B3 in the port's pipeline
# raster; the reference holds only the B1 route.
DIRECT_ROW_LIMIT = 150_000

_RECORDERS: list = []


@contextlib.contextmanager
def record(calls: list):
    """Within the block, every rasterize_direct call appends a dict to
    calls: width, height (of the whole target), band_h, depth_mode,
    track_ids and the setup it rasterized."""
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def _check_depth_mode(name, depth_mode):
    if depth_mode not in (DEPTH_VIEWZ, DEPTH_NDC01):
        raise ValueError(f"{name}: unknown depth_mode {depth_mode}")


def _targets(depth_init, tid_init, height, width, dev):
    """Default (cleared) depth / tid targets."""
    if depth_init is None:
        depth_init = torch.ones((height, width), dtype=torch.float32,
                                device=dev)
    if tid_init is None:
        tid_init = torch.full((height, width), -1, dtype=torch.int32,
                              device=dev)
    return depth_init, tid_init


def rasterize_direct(setup: TriSetup, width: int, height: int, zn,
                     zf, depth_init=None, tid_init=None,
                     depth_mode: int = DEPTH_VIEWZ, tile_h: int = 128,
                     tile_w: int = 128, chunk: int = 16, y_offset: int = 0,
                     full_height: int | None = None, track_ids: bool = True,
                     band_h: int = 0, spatial_sort: bool = False):
    """The plain route of the port's rasterize_direct: (depth01 (H, W)
    f32, tid (H, W) i32, None).  track_ids=False resolves depth only (tid
    comes back as tid_init); band_h > 0 is a stack of slots of band_h rows,
    each setup row slot-local but kept by a bbox in global rows; y_offset /
    full_height a screen band of a taller frame.  tile_h, tile_w, chunk and
    spatial_sort change neither depth nor tid."""
    y_offset = int(y_offset)
    full_height = height if full_height is None else int(full_height)
    if band_h and spatial_sort:
        raise ValueError("rasterize_direct: spatial_sort mixes the slots of "
                         "a band_h stack")
    if band_h and height % band_h:
        raise ValueError(f"rasterize_direct: height {height} is not a whole "
                         f"number of bands of {band_h} rows")
    if band_h and (y_offset or full_height != height):
        raise ValueError("rasterize_direct: band_h (a slot stack) and a "
                         "screen band (y_offset, full_height) do not combine")
    if y_offset < 0 or y_offset + height > full_height:
        raise ValueError(f"rasterize_direct: rows [{y_offset}, "
                         f"{y_offset + height}) lie outside a frame of "
                         f"{full_height} rows")
    if _SUPER % chunk:
        raise ValueError(f"rasterize_direct: chunk {chunk} must divide "
                         f"{_SUPER}")
    _check_depth_mode("rasterize_direct", depth_mode)
    dev = setup.coef.device

    for calls in _RECORDERS:
        calls.append(dict(width=width, height=height, band_h=band_h,
                          depth_mode=depth_mode, track_ids=track_ids,
                          setup=setup))
    depth_init, tid_init = _targets(depth_init, tid_init, height, width,
                                    dev)
    if band_h:
        depth, tid = _banded_brute(setup, width, height, band_h, zn, zf,
                                   depth_init, tid_init, depth_mode)
    else:
        depth, tid = rasterize_brute(setup, width, height, zn, zf,
                                     depth_init=depth_init,
                                     tid_init=tid_init,
                                     depth_mode=depth_mode,
                                     y_offset=y_offset,
                                     full_height=full_height)
    return depth, (tid if track_ids else tid_init.clone()), None


def _banded_brute(setup: TriSetup, width: int, height: int, band_h: int,
                  zn, zf, depth_init, tid_init, depth_mode):
    """rasterize_brute per band of a band_h stack: band b's rows [b * band_h,
    (b + 1) * band_h) take the setup rows whose bbox meets them, evaluated
    at band-local rows (their bboxes moved to band-local rows too)."""
    depth, tid = [], []
    y0, y1 = setup.bbox[:, 1], setup.bbox[:, 3]
    for b in range(height // band_h):
        lo, hi = b * band_h, (b + 1) * band_h
        shift = torch.tensor([0, lo, 0, lo], dtype=setup.bbox.dtype,
                             device=setup.bbox.device)
        st = dataclasses.replace(setup,
                                 valid=setup.valid & (y0 < hi) & (y1 >= lo),
                                 bbox=setup.bbox - shift)
        d, t = rasterize_brute(st, width, band_h, zn, zf,
                               depth_init=depth_init[lo:hi],
                               tid_init=tid_init[lo:hi],
                               depth_mode=depth_mode)
        depth.append(d)
        tid.append(t)
    return torch.cat(depth), torch.cat(tid)
