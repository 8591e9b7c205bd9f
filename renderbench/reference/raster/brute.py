"""Plain visibility rasterizer: the reference's raster (the port's
raster/brute.py:rasterize_brute, each chunk of rows evaluated over its
rows' joint bbox only).

Evaluates coverage of fixed-size chunks of the valid rows, in order, and
resolves by (min depth, first submitted), which equals the lexicographic
(depth, triangle id) minimum.
"""

from __future__ import annotations

import numpy as np
import torch

from renderbench.reference.core.util import device_const, f32_on
from renderbench.reference.raster.setup import DEPTH_VIEWZ, TriSetup


def depth_params(zn, zf):
    """(zn, inv_range) of host floats as the float32 values the raster uses:
    inv_range = 1 / max(zf - zn, 1e-6), all in f32 like lsr_tpu."""
    zn32 = np.float32(zn)
    rng = np.maximum(np.float32(zf) - zn32, np.float32(1e-6))
    return float(zn32), float(np.float32(1.0) / rng)


def zparams(zn, zf, device):
    """The rasters' z params as data: a (2,) f32 tensor [zn, inv_range] on
    `device`, the port's z_ref (lsr_tpu/raster/tiled.py:585-589), which
    kernels B1, B3 and B4 and their plain versions read.  zn / zf are 0-d
    tensors (a camera's, lsr_tpu's data fields) or host numbers.  Tensors
    give [zn, 1 / clamp_min(zf - zn, 1e-6)] by device ops, the same IEEE
    f32 operations as depth_params, so the pair is bit for bit
    depth_params' and one captured frame serves every zn / zf.  Host
    numbers give depth_params' pair as a memoised device_const (the sun
    map's (0.0, 1.0)): a captured frame makes no constant after its
    warm-up."""
    if isinstance(zn, torch.Tensor) or isinstance(zf, torch.Tensor):
        zn, zf = f32_on(zn, device), f32_on(zf, device)
        inv = torch.reciprocal(torch.clamp(zf - zn, min=1e-6))
        return torch.stack([zn.reshape(()), inv.reshape(())])
    return device_const(depth_params(zn, zf), device)


def rasterize_brute(setup: TriSetup, width: int, height: int, zn,
                    zf, depth_init=None, tid_init=None,
                    depth_mode: int = DEPTH_VIEWZ, chunk: int = 64,
                    y_offset: int = 0, full_height: int | None = None):
    """Rasterize all triangles in `setup`; returns (depth01 (H, W) f32,
    tid (H, W) i32).  y_offset / full_height: the target is global rows
    [y_offset, y_offset + height) of a full_height frame (a screen band);
    each pixel is evaluated at its global row, so bands of one frame
    concatenate to the whole frame bit for bit."""
    dev = setup.coef.device
    n = setup.coef.shape[0]
    full_height = height if full_height is None else full_height
    zp = zparams(zn, zf, dev)
    zn_f, inv_range = zp[0], zp[1]
    px = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    py = (torch.arange(int(y_offset), int(y_offset) + height,
                       dtype=torch.float32, device=dev) + 0.5)[:, None]
    # Pixel centers in the last row/column ((W-1)+0.5) are never covered:
    # the reference clips to screen coords [0, W-1] x [0, H-1].
    ndc_mask = (px <= (width - 1)) & (py <= (full_height - 1))
    depth = torch.ones((height, width), dtype=torch.float32, device=dev) \
        if depth_init is None else depth_init.clone()
    tid = torch.full((height, width), -1, dtype=torch.int32, device=dev) \
        if tid_init is None else tid_init.clone()
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    # Only the valid rows are walked, in order, each chunk of rows over the
    # pixels of its rows' joint bbox (one host read of the bboxes): a pixel
    # outside every bbox of a chunk keeps its depth and tid, as the port's
    # kernel B1 leaves the pixels outside its chunks' boxes.  Neither
    # changes (min depth, first submitted) at any pixel the rows cover.
    keep = torch.nonzero(setup.valid)[:, 0]
    coef, iw, ziw, ids = (setup.coef[keep], setup.iw[keep], setup.ziw[keep],
                          ids[keep])
    boxes = setup.bbox[keep].cpu().numpy()
    y_off = int(y_offset)

    for s in range(0, coef.shape[0], chunk):
        bb = boxes[s:s + chunk]
        x0 = max(int(bb[:, 0].min()), 0)
        x1 = min(int(bb[:, 2].max()) + 1, width)
        y0 = max(int(bb[:, 1].min()) - y_off, 0)
        y1 = min(int(bb[:, 3].max()) + 1 - y_off, height)
        if x0 >= x1 or y0 >= y1:
            continue
        c = coef[s:s + chunk]
        w_ = iw[s:s + chunk]
        z_ = ziw[s:s + chunk]
        pxs, pys = px[:, x0:x1], py[y0:y1]
        mask = ndc_mask[y0:y1, x0:x1]

        def col(a, j):
            return a[:, j][:, None, None]

        def bc(i):
            return (col(c, 3 * i) * pxs[None] + col(c, 3 * i + 1) * pys[None]
                    + col(c, 3 * i + 2))

        bc0, bc1, bc2 = bc(0), bc(1), bc(2)
        inside = ((bc0 >= 0.0) & (bc1 >= 0.0) & (bc2 >= 0.0) & mask[None])
        denom = bc0 * col(w_, 0) + bc1 * col(w_, 1) + bc2 * col(w_, 2)
        inside &= denom > 1e-10
        if depth_mode == DEPTH_VIEWZ:
            view_z = 1.0 / torch.clamp(denom, min=1e-10)
            z01 = torch.clamp((view_z - zn_f) * inv_range, 0.0, 1.0)
        else:
            zlin = (bc0 * col(z_, 0) + bc1 * col(z_, 1) + bc2 * col(z_, 2)) \
                / torch.clamp(denom, min=1e-10)
            z01 = torch.clamp(zlin * 0.5 + 0.5, 0.0, 1.0)
        cand = torch.where(inside, z01, torch.full_like(z01, float("inf")))
        best, kidx = torch.min(cand, dim=0)   # first minimum = first submitted
        d_blk = depth[y0:y1, x0:x1]
        upd = best < d_blk
        depth[y0:y1, x0:x1] = torch.where(upd, best, d_blk)
        tid[y0:y1, x0:x1] = torch.where(upd, ids[s:s + chunk][kidx],
                                        tid[y0:y1, x0:x1])
    return depth, tid
