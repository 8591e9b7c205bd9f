"""Listless tiled rasterizer: kernel B1 (port of lsr_tpu/raster/tiled.py:
_chunk_bboxes, _super_lists, rasterize_direct / _direct_kernel).

Setup records stay resident; triangles are grouped in supers of 256
(_SUPER), each made of chunks of 16.  Per 128x128 screen tile, torch ops
build the list of supers whose bbox overlaps the tile; the CUDA kernel
(csrc/direct_raster.cu) walks its tile's list, skips chunks whose bbox
misses its 16x16 pixel block, and resolves (min depth, first submitted) or,
with spatial_sort, the lexicographic (depth, tid) minimum.

Setup record layout (16 f32 per triangle):
  [0:9] A0,B0,C0,A1,B1,C1,A2,B2,C2 | [9:12] 1/w | [12:15] z_ndc/w |
  [15] triangle id as f32 (-1 = invalid; exact below 2^24 triangles)

For CPU tensors rasterize_direct runs its plain version, rasterize_brute,
which gives the same depth and, in both tie modes, the same tids.
"""

from __future__ import annotations

import torch

from lsr_tpu_torch.core.util import cdiv
from lsr_tpu_torch.raster.brute import depth_params, rasterize_brute
from lsr_tpu_torch.raster.setup import DEPTH_NDC01, DEPTH_VIEWZ, TriSetup
from lsr_tpu_torch.utils.cuda_build import check_launch, load_kernels

_SUPER = 256  # triangles per super-chunk


def _chunk_bboxes(setup: TriSetup, n_pad: int, chunk: int):
    """(n_pad/chunk, 4) f32 chunk bboxes (x0,y0,x1,y1); empty for invalid."""
    big = 1e9
    bb = setup.bbox.to(torch.float32)
    v = setup.valid

    def col(j, fill):
        x = torch.where(v, bb[:, j], torch.full_like(bb[:, j], fill))
        pad = torch.full((n_pad - x.shape[0],), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad]).reshape(-1, chunk)

    return torch.stack([col(0, big).min(dim=1).values,
                        col(1, big).min(dim=1).values,
                        col(2, -big).max(dim=1).values,
                        col(3, -big).max(dim=1).values], dim=-1)


def _super_lists(chunk_bb, chunk: int, tiles_x: int, tiles_y: int,
                 tile_w: int, tile_h: int):
    """Per-tile overlapping-super lists from chunk bboxes.

    Lists are sized by the number of supers, the bound of every count, so
    no list is ever clamped (the TPU clamped them to fit its SMEM).
    Returns (lists (tiles, S) i32 -1 padded, counts (tiles,) i32,
    max_count () i32)."""
    dev = chunk_bb.device
    cps = _SUPER // chunk
    s = chunk_bb.shape[0] // cps
    sb = chunk_bb.reshape(s, cps, 4)
    sx0 = sb[..., 0].min(dim=1).values
    sy0 = sb[..., 1].min(dim=1).values
    sx1 = sb[..., 2].max(dim=1).values
    sy1 = sb[..., 3].max(dim=1).values
    tx = torch.arange(tiles_x, dtype=torch.float32, device=dev) * tile_w
    ty = torch.arange(tiles_y, dtype=torch.float32, device=dev) * tile_h
    ox = (sx0[None, :] <= tx[:, None] + (tile_w - 1)) & (sx1[None, :] >= tx[:, None])
    oy = (sy0[None, :] <= ty[:, None] + (tile_h - 1)) & (sy1[None, :] >= ty[:, None])
    mask = (oy[:, None, :] & ox[None, :, :]).reshape(tiles_y * tiles_x, s)
    return _mask_to_lists(mask)


def _mask_to_lists(mask):
    """(tiles, S) bool -> order-preserving (lists (tiles, S) i32 -1 padded,
    counts (tiles,) i32, max_count () i32)."""
    tiles, s = mask.shape
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    counts = mask.sum(dim=1, dtype=torch.int32)
    base = (torch.arange(tiles, device=mask.device) * s)[:, None]
    flat = torch.where(mask, base + pos, torch.full_like(base, tiles * s))
    ids = torch.arange(s, dtype=torch.int32, device=mask.device)
    lists = torch.full((tiles * s + 1,), -1, dtype=torch.int32,
                       device=mask.device)
    lists[flat.reshape(-1)] = ids.expand(tiles, s).reshape(-1)
    return lists[:-1].reshape(tiles, s), counts, counts.max()


def pack_direct_records(setup: TriSetup, spatial_sort: bool,
                        tile_w: int = 128, tile_h: int = 128):
    """Sorted-or-not setup -> (rec (n_pad, 16) f32, sorted setup rows).

    spatial_sort reorders rows by bbox-center tile (stable), so chunk and
    super bboxes are tight; lane 15 keeps the CALLER's triangle ids."""
    n = setup.coef.shape[0]
    dev = setup.coef.device
    ids = torch.arange(n, dtype=torch.float32, device=dev)
    coef, iw, ziw, bbox, valid = (setup.coef, setup.iw, setup.ziw,
                                  setup.bbox, setup.valid)
    if spatial_sort:
        cx = torch.div(bbox[:, 0] + bbox[:, 2], 2, rounding_mode="floor")
        cy = torch.div(bbox[:, 1] + bbox[:, 3], 2, rounding_mode="floor")
        key = (cy // tile_h) * (1 << 15) + (cx // tile_w)
        key = torch.where(valid, key, torch.full_like(key, 1 << 29))
        order = torch.argsort(key, stable=True)
        coef, iw, ziw, bbox, valid, ids = (
            coef[order], iw[order], ziw[order], bbox[order], valid[order],
            ids[order])
    n_pad = cdiv(max(n, 1), _SUPER) * _SUPER
    rec = torch.zeros((n_pad, 16), dtype=torch.float32, device=dev)
    rec[:n, 0:9] = coef
    rec[:n, 9:12] = iw
    rec[:n, 12:15] = ziw
    rec[:, 15] = -1.0
    rec[:n, 15] = torch.where(valid, ids, torch.full_like(ids, -1.0))
    sorted_setup = TriSetup(coef=coef, iw=iw, ziw=ziw, bbox=bbox, valid=valid,
                            obj_id=setup.obj_id, wp=setup.wp, nw=setup.nw,
                            uv=setup.uv)
    return rec, sorted_setup, n_pad


def _direct_launch(lib, rec, chunk_bb, slists, counts, depth_init, tid_init,
                   width, height, zn, zf, depth_mode, track_ids, tie_tid,
                   stream):
    """Launch kernel B1 through the C interface; returns (depth, tid)."""
    dev = rec.device
    zn_f, inv_range = depth_params(zn, zf)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tid = torch.empty((height, width), dtype=torch.int32, device=dev)
    chunk_bb = chunk_bb.contiguous()
    err = lib.lsr_direct_raster(
        rec.data_ptr(), chunk_bb.data_ptr(), slists.data_ptr(),
        counts.data_ptr(), depth_init.data_ptr(), tid_init.data_ptr(),
        depth.data_ptr(), tid.data_ptr(), width, height,
        cdiv(width, 128), slists.shape[1], zn_f, inv_range,
        float(height - 1), depth_mode, int(track_ids), int(tie_tid), stream)
    check_launch("lsr_direct_raster", err)
    return depth, tid


def rasterize_direct(setup: TriSetup, width: int, height: int, zn: float,
                     zf: float, depth_init=None, tid_init=None,
                     depth_mode: int = DEPTH_VIEWZ, tile_h: int = 128,
                     tile_w: int = 128, chunk: int = 16, y_offset=0,
                     track_ids: bool = True, band_h: int = 0,
                     spatial_sort: bool = False):
    """Listless tiled rasterization.  Returns (depth01 (H, W) f32,
    tid (H, W) i32, max_supers_per_tile () i32).

    track_ids=False resolves depth only (tid comes back as tid_init).
    spatial_sort=True resolves exact z ties by min tid, which equals the
    unsorted first-submitted rule; emitted tids index the caller's rows.
    CPU tensors run the plain version (rasterize_brute); CUDA tensors launch
    kernel B1 or raise."""
    if band_h:
        raise NotImplementedError("rasterize_direct: band_h (stacked atlas "
                                  "bands) is not ported yet")
    if y_offset != 0:
        raise NotImplementedError("rasterize_direct: y_offset != 0 (screen "
                                  "bands) is not ported yet")
    if (tile_h, tile_w, chunk) != (128, 128, 16):
        raise ValueError("rasterize_direct: the kernel is built for 128x128 "
                         "tiles and 16-triangle chunks")
    if depth_mode not in (DEPTH_VIEWZ, DEPTH_NDC01):
        raise ValueError(f"rasterize_direct: unknown depth_mode {depth_mode}")
    dev = setup.coef.device
    tiles_x = cdiv(width, tile_w)
    tiles_y = cdiv(height, tile_h)

    rec, sorted_setup, n_pad = pack_direct_records(setup, spatial_sort,
                                                   tile_w, tile_h)
    chunk_bb = _chunk_bboxes(sorted_setup, n_pad, chunk)
    slists, counts, max_sup = _super_lists(chunk_bb, chunk, tiles_x, tiles_y,
                                           tile_w, tile_h)

    if depth_init is None:
        depth_init = torch.ones((height, width), dtype=torch.float32,
                                device=dev)
    if tid_init is None:
        tid_init = torch.full((height, width), -1, dtype=torch.int32,
                              device=dev)

    if dev.type == "cpu":
        depth, tid = rasterize_brute(setup, width, height, zn, zf,
                                     depth_init=depth_init, tid_init=tid_init,
                                     depth_mode=depth_mode)
        return depth, (tid if track_ids else tid_init.clone()), max_sup

    if dev.type != "cuda":
        raise ValueError(f"rasterize_direct: unsupported device {dev}")
    for name, t, dt in (("depth_init", depth_init, torch.float32),
                        ("tid_init", tid_init, torch.int32)):
        if (t.device != dev or t.dtype != dt or t.shape != (height, width)
                or not t.is_contiguous()):
            raise ValueError(f"rasterize_direct: {name} must be a contiguous "
                             f"{dt} ({height}, {width}) tensor on {dev}")
    depth, tid = _direct_launch(
        load_kernels(), rec, chunk_bb, slists, counts, depth_init, tid_init,
        width, height, zn, zf, depth_mode, track_ids, spatial_sort,
        torch.cuda.current_stream(dev).cuda_stream)
    rasterize_direct.launches += 1
    return depth, (tid if track_ids else tid_init.clone()), max_sup


rasterize_direct.launches = 0
